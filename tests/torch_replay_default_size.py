"""SchedulingReplay at its JAX default size (500 nodes, 16 rounds at scale
20) through the JAX loop and the port's loop on the CPU, in one process,
both arms, in the batch cycle and one pod per cycle (``schedule_one``,
the JAX harness's ``oracle`` backend). Prints one JSON line per (mode,
arm) with both packages' ReplayInvariants and whether the JAX acceptance
bars (``tests/test_rebalance.py:363-394``) hold in that mode.

Not a test (a run takes minutes): the numbers behind the open item on the
replay's bars at its default size. Run from the repo root:

    env JAX_PLATFORMS=cpu python tests/torch_replay_default_size.py [--nodes 500]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _torch_cases import LoopPair, Recorders, to_jax  # noqa: E402


def run(nodes: int, rebalance: bool, sequential: bool) -> dict:
    from kubernetes_tpu.controllers.rebalance import score_from_snapshot as jscore
    from kubernetes_tpu_torch.perf import workloads

    w = workloads.scheduling_replay(nodes, rebalance=rebalance)
    pair = LoopPair(batch=workloads.LOOP_BATCH, percentage=100)
    for ni in w.node_infos():
        pair.jstore.create_node(to_jax(ni.node))
        pair.tstore.create_node(ni.node)
    for q in w.quotas():
        pair.add_quota(q.meta.namespace, q.hard, weight=q.weight, cohort=q.cohort)
    out = {}
    with Recorders(pair, telemetry=False, tracing=False):
        t = time.perf_counter()
        out["jax"] = workloads.replay_rounds(w, pair.jstore, pair.jsched, pair.jclock,
                                             convert=to_jax, score_fn=jscore,
                                             sequential=sequential)
        out["jax_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["port"] = workloads.replay_rounds(w, pair.tstore, pair.tsched, pair.tclock,
                                              sequential=sequential)
        out["port_s"] = time.perf_counter() - t
    return out


def bars(on: dict, off: dict, on_t: dict, off_t: dict) -> dict:
    """The JAX acceptance test's three asserts, each True or False."""
    p99 = all(t_on["E2eP99"] <= off_t[ns]["E2eP99"] * 3.0 + 0.5
              for ns, t_on in on_t.items() if t_on["E2eCount"] and off_t[ns]["E2eCount"])
    return {
        "ran_and_converged": bool(on["Waves"] > 0 and on["Migrations"] > 0
                                  and off["Waves"] == 0 and not on["PendingUncordons"]
                                  and not on["PendingAtEnd"] and not off["PendingAtEnd"]
                                  and not on["Suspended"]),
        "packing_better": bool(on["PackingEff"] > off["PackingEff"] + 0.005
                               and on["FinalEntropy"] < off["FinalEntropy"]),
        "no_tenant_p99_moved": bool(p99 and on["TenantP99Max"]
                                    <= off["TenantP99Max"] * 3.0 + 0.5),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=500)
    args = ap.parse_args()
    os.environ["KTPU_COMMIT_WORKER"] = "0"
    for mode in ("batch", "sequential"):
        runs = {arm: run(args.nodes, arm, mode == "sequential") for arm in (True, False)}
        for side in ("jax", "port"):
            on, off = runs[True][side], runs[False][side]
            print(json.dumps({
                "nodes": args.nodes, "mode": mode, "loop": side,
                "on": on["invariants"], "off": off["invariants"],
                "waves_on": len(on["waves"]), "cycles": [on["cycles"], off["cycles"]],
                "seconds": [runs[True][f"{side}_s"], runs[False][f"{side}_s"]],
                "bars": bars(on["invariants"], off["invariants"], on["tenants"],
                             off["tenants"]),
            }), flush=True)


if __name__ == "__main__":
    main()
