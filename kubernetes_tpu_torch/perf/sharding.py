"""Sharded batches of the workloads, and what the sharded program's
collectives cost on the card.

    python -m kubernetes_tpu_torch.perf.sharding

``batch_inputs`` encodes one batch as the main path does (``DeviceState``
and ``encode_device_batch``), with the sharded program's keywords for its
topology mode; ``bind_init`` binds a workload's init pods one per node.
``chip_smoke.py``'s shard phases build their batches with them.

Run as a module on the card, it prints one JSON object per part, each with
the card's name and power limit:

* ``collectives``: µs per ``NodeMesh.all_reduce`` (sum, int32) of 1 and of
  300,000 elements, and per exchange of the winner rows the program sends
  (int32 [1, 4], a scan step's, and [128, 3], a round's) both ways: a
  ``NodeMesh.all_gather`` and the all-reduce of a [W, ...] buffer with each
  rank's row in its own slot (``ops/topology.py:_gfirst_max``'s way),
  averaged over 200 calls (20 for the 300,000) after a warm-up, every rank
  on the card: W=1 over NCCL and over gloo, W=2 and 4 over gloo; and over
  gloo on CPU tensors at W=4;
* ``spread``: TopologySpreading/5000Nodes' first measured batch (its 5000
  init pods bound one per node) at W=4 on the card, the scan and the
  rounds: host ms of each batch (a first and one more) and the
  collectives of one batch.

``python -m kubernetes_tpu_torch.perf.sharding spread`` runs the second
part alone. Every rank shares the one card: no number here measures
scaling.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional

import torch

from ..backend.batch_scheduler import encode_device_batch
from ..backend.device_state import DeviceState, caps_for_cluster
from ..cache.snapshot import Snapshot
from ..ops.schema import Capacities
from ..parallel import launch
from . import workloads


def batch_inputs(infos, pods, caps: Optional[Capacities] = None) -> tuple:
    """(nt, pb, et, tc, tb, kw) on the CPU: ``pods`` encoded against
    ``infos`` by the main path, ``kw`` the sharded program's keywords for
    the batch's topology mode (``topo_enabled``, ``topo_mode``,
    ``vd_override``, ``host_key``)."""
    ds = DeviceState(caps or caps_for_cluster(len(infos)), "cpu")
    ds.sync(Snapshot(infos))
    enc = encode_device_batch(ds, pods)
    kw = dict(topo_enabled=enc.mode != "off", topo_mode=enc.mode, vd_override=enc.vd,
              host_key=enc.host_key)
    return ds.nt, enc.pb, enc.et, ds.tc, enc.tb, kw


def bind_init(w, pods: int):
    """``w``'s NodeInfos with its first ``pods`` init pods bound one per
    node, in order (every init shape of the topology workloads fits one
    per node)."""
    infos = w.node_infos()
    for i, pod in enumerate(w.init_pod_list()[:pods]):
        ni = infos[i % len(infos)]
        pod.spec.node_name = ni.node.meta.name
        ni.add_pod(pod)
    return infos


def _collective_us(mesh) -> dict:
    """Rank program: µs per all-reduce and per all-gather, as the module
    docstring says."""
    def per_call(op, x, reps):
        for _ in range(5):
            op(x)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            op(x)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    def ones(*shape):
        return torch.ones(shape, dtype=torch.int32, device=mesh.device)

    def reduce(x):
        return mesh.all_reduce(x, "sum")

    def gather(x):
        return mesh.all_gather(x, 0)

    def placed(x):
        rows = torch.zeros((mesh.world,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        rows[mesh.rank] = x
        return mesh.all_reduce(rows, "sum")

    out = {"all_reduce 1": per_call(reduce, ones(1), 200),
           "all_reduce 300000": per_call(reduce, ones(300_000), 20)}
    for shape in ((1, 4), (128, 3)):
        name = "x".join(map(str, shape))
        out[f"all_gather {name}"] = per_call(gather, ones(*shape), 200)
        out[f"placed all_reduce {name}"] = per_call(placed, ones(*shape), 200)
    return out


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"


def collectives_part(card: str) -> None:
    rows = []
    for world, backend in ((1, "nccl"), (1, "gloo"), (2, "gloo"), (4, "gloo")):
        us = launch.run_ranks(_collective_us, world, backend, device="cuda", timeout_s=300)[0]
        rows.append({"device": "cuda", "world": world, "backend": backend, "us": us})
    us = launch.run_ranks(_collective_us, 4, device="cpu", timeout_s=300)[0]
    rows.append({"device": "cpu", "world": 4, "backend": "gloo", "us": us})
    print(json.dumps({"part": "collectives", "card": card, "rows": rows}), flush=True)


def spread_part(card: str) -> None:
    spread = workloads.topology_spreading()
    nt, pb, et, tc, tb, kw = batch_inputs(bind_init(spread, spread.init_pods),
                                          spread.measured_pod_list()[:128])
    cases = [launch.case_fields(pb, et, nt, tc, tb, spec_decode=spec, repeat=1, **kw)
             for spec in (False, True)]
    recs = launch.run_ranks(launch.schedule_cases, 4, device="cuda", args=(cases,),
                            timeout_s=900)[0]
    print(json.dumps({"part": "spread", "card": card, "world": 4, "mode": kw["topo_mode"],
                      **{run: {"ms": r["ms"], "collectives": r["collectives"],
                               "collective_bytes": r["collective_bytes"]}
                         for run, r in zip(("scan", "rounds"), recs)}}), flush=True)


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("perf.sharding measures the card: no CUDA device is available")
    parts = (argv if argv is not None else sys.argv[1:]) or ["collectives", "spread"]
    card = _card()
    for part in parts:
        {"collectives": collectives_part, "spread": spread_part}[part](card)


if __name__ == "__main__":
    main()
