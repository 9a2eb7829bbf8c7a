"""The port's driver entry points (counterpart of ``__graft_entry__.py``).

``entry(device)``: the single-device batch step on a small topology batch,
as ``(fn, args)``; ``fn(*args)`` returns the BatchResult.

``dryrun_multichip(n, device)``: the same step sharded over ``n`` ranks on
the node axis (``parallel/``), one process per rank, running the JAX
dryrun's four programs with its checks:

1. topology (soft zone spread, preferred node affinity, taints): the
   sharded scan equals the sharded rounds in mode ``general``;
2. required anti-affinity on the hostname key with a zone spread: every pod
   placed, no node shared, winners on every rank's window;
3. topology off: the sharded rounds equal the sharded scan;
4. the hostname mode (spread and anti-affinity on the hostname key): the
   sharded rounds equal the single-device scan.

The backend is ``nccl`` for one rank on the card and ``gloo`` otherwise.

Run on the card: ``python -c "from kubernetes_tpu_torch import entry;
fn, a = entry.entry(); print(fn(*a).node_idx)"`` and
``python -c "from kubernetes_tpu_torch import entry;
entry.dryrun_multichip(4)"``; on the CPU pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .api.types import SCHEDULE_ANYWAY, LabelSelector
from .api.wrappers import make_node, make_pod
from .backend.batch import DEFAULT_WEIGHTS, schedule_batch_core, spec_decode_eligible
from .backend.sig_table import SigTable
from .framework.plugins.interpodaffinity import HOSTNAME_KEY
from .framework.types import NodeInfo
from .ops.encode import ClusterEncoder
from .ops.schema import Capacities
from .parallel.launch import case_fields, run_ranks, schedule_cases
from .utils.device import DeviceLike, resolve_device


def _encode(infos, pods, n_nodes: int, n_pods: int, device, value_words: int = 32):
    enc = ClusterEncoder(Capacities(nodes=n_nodes, pods=n_pods, value_words=value_words),
                         device=device)
    sig = SigTable(enc)
    nt = enc.encode_snapshot(infos)
    pb, et = enc.encode_pods(pods)
    tb = sig.encode_topo(pods)  # registers the batch's rows before the counts are read
    return enc, nt, pb, et, sig.topo_counts(), tb


def _build_inputs(n_nodes: int, n_pods: int, device, value_words: int = 32):
    """(nt, pb, et, tc, tb) of ``__graft_entry__._build_inputs``: zones,
    disks and PreferNoSchedule taints; pods with zone affinity, a preferred
    disk, priorities and a soft zone spread on half of them."""
    infos = []
    for i in range(n_nodes):
        nw = (make_node(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": 110})
              .label("zone", f"z{i % 4}").label("disk", "ssd" if i % 2 else "hdd"))
        if i % 5 == 0:
            nw.taint("dedicated", "batch", "PreferNoSchedule")
        infos.append(NodeInfo(nw.obj()))
    pods = []
    for i in range(n_pods):
        pw = make_pod(f"pod-{i}").req({"cpu": "500m", "memory": "1Gi"}).priority(i % 3)
        pw.label("app", f"svc{i % 2}")
        if i % 4 == 0:
            pw.node_affinity_in("zone", [f"z{i % 4}"])
        if i % 3 == 0:
            pw.preferred_node_affinity(10, "disk", ["ssd"])
        if i % 2 == 0:
            pw.spread_constraint(2, "zone", when_unsatisfiable=SCHEDULE_ANYWAY,
                                 selector=LabelSelector(match_labels={"app": f"svc{i % 2}"}))
        pods.append(pw.obj())
    return _encode(infos, pods, n_nodes, n_pods, device, value_words)[1:]


def _build_affinity_inputs(n_nodes: int, n_pods: int, device):
    """Every pod carries color=red and a required anti-affinity to color=red
    on the hostname key, with a zone spread: at most one pod per node."""
    infos = [NodeInfo(make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "32Gi", "pods": 110}).label(HOSTNAME_KEY, f"node-{i}")
        .label("zone", f"z{i % 4}").obj()) for i in range(n_nodes)]
    sel = LabelSelector(match_labels={"color": "red"})
    pods = []
    for i in range(n_pods):
        pw = make_pod(f"anti-{i}").req({"cpu": "250m", "memory": "512Mi"}).label("color", "red")
        pw.pod_affinity(HOSTNAME_KEY, sel, anti=True)
        pw.spread_constraint(1, "zone", selector=sel)
        pods.append(pw.obj())
    return _encode(infos, pods, n_nodes, n_pods, device)[1:]


def _build_hostname_inputs(n_nodes: int, n_pods: int, device):
    """(nt, pb, et, tc, tb, host_key): a hostname spread on every pod and a
    hostname anti-affinity on every other one."""
    infos = [NodeInfo(make_node(f"node-{i}").capacity(
        {"cpu": "8", "memory": "32Gi", "pods": 110}).label(HOSTNAME_KEY, f"node-{i}").obj())
        for i in range(n_nodes)]
    sel = LabelSelector(match_labels={"color": "red"})
    pods = []
    for i in range(n_pods):
        pw = make_pod(f"h{i}").req({"cpu": "250m", "memory": "512Mi"}).label("color", "red")
        pw.spread_constraint(1, HOSTNAME_KEY, selector=sel)
        if i % 2 == 0:
            pw.pod_affinity(HOSTNAME_KEY, sel, anti=True)
        pods.append(pw.obj())
    enc, *rest = _encode(infos, pods, n_nodes, n_pods, device)
    return (*rest, enc.key_slot(HOSTNAME_KEY))


def entry(device: DeviceLike = None):
    """(fn, args): the single-device batch step at 64 nodes and 16 pods, in
    topology mode ``general``; ``fn(*args)`` is the BatchResult. ``device``
    None is the card (raises without one)."""
    dev = resolve_device(device)
    nt, pb, et, tc, tb = _build_inputs(n_nodes=64, n_pods=16, device=dev)

    def fn(pb, et, nt, tc, tb):
        return schedule_batch_core(pb, et, nt, DEFAULT_WEIGHTS, tc, tb, "general",
                                   spec_decode=spec_decode_eligible("general", dev))

    return fn, (pb, et, nt, tc, tb)


# the dryrun's sharded runs, in order: (program, inputs, keywords)
DRYRUN_RUNS = (("topology_scan", "topo", dict(topo_enabled=True)),
               ("topology_rounds", "topo", dict(topo_enabled=True, spec_decode=True,
                                                topo_mode="general")),
               ("anti_scan", "anti", dict(topo_enabled=True)),
               ("off_scan", "off", dict(topo_enabled=False)),
               ("off_rounds", "off", dict(topo_enabled=False, spec_decode=True)),
               ("host_rounds", "host", dict(topo_enabled=True, spec_decode=True,
                                            topo_mode="host")))


def _check(ok, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _dryrun_inputs(n_devices: int, device="cpu") -> Dict[str, tuple]:
    """The dryrun's encoded batches on ``device``: name -> (nt, pb, et, tc,
    tb) (``host`` adds the hostname key slot), at 32 nodes per rank and 64
    pods (32 in the hostname program)."""
    n_nodes, n_pods = 32 * n_devices, 64
    return {"topo": _build_inputs(n_nodes, n_pods, device),
            "anti": _build_affinity_inputs(n_nodes, n_pods, device),
            "off": _build_inputs(n_nodes, n_pods, device),
            "host": _build_hostname_inputs(n_nodes, 32, device)}


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     backend: Optional[str] = None, timeout_s: float = 600.0) -> dict:
    """Run the four programs over ``n_devices`` ranks on ``device`` (None:
    the card, every rank on it) and check them as the JAX dryrun does;
    raises on any failure. Returns ``node_idx`` (run name -> the winners,
    ``host_single`` the single-device scan of program 4) and ``ranks``
    (each rank's ``schedule_cases`` records without the results)."""
    dev = resolve_device(device)
    inputs = _dryrun_inputs(n_devices)
    cases = []
    for _name, which, kw in DRYRUN_RUNS:
        nt, pb, et, tc, tb = inputs[which][:5]
        kw = dict(kw, host_key=inputs["host"][5]) if which == "host" else kw
        cases.append(case_fields(pb, et, nt, tc, tb, **kw))
    ranks = run_ranks(schedule_cases, n_devices, backend, dev, (cases,), timeout_s)
    idx = {name: rec["result"]["node_idx"] for (name, _w, _k), rec in zip(DRYRUN_RUNS, ranks[0])}
    n_nodes = 32 * n_devices

    topo = idx["topology_scan"]
    _check(topo.shape == (64,) and (topo >= 0).all() and (topo < n_nodes).all(),
           "dryrun topology workload must be schedulable")
    _check(np.array_equal(topo, idx["topology_rounds"]),
           "sharded general-mode rounds diverged from the sharded scan")
    placed = idx["anti_scan"][idx["anti_scan"] >= 0]
    _check(len(placed) == 64, "one empty node per pod must exist")
    _check(len(set(placed.tolist())) == len(placed), "anti-affinity violated: a node shared")
    ranks_hit = {int(s) // (n_nodes // n_devices) for s in placed}
    _check(len(ranks_hit) == n_devices, f"winners must spread across all ranks, hit {ranks_hit}")
    _check(np.array_equal(idx["off_scan"], idx["off_rounds"]),
           "sharded rounds diverged from the sharded scan")

    nt, pb, et, tc, tb, host_key = _build_hostname_inputs(n_nodes, 32, dev)
    single = schedule_batch_core(pb, et, nt, DEFAULT_WEIGHTS, tc, tb, "host",
                                 host_key=host_key, spec_decode=False)
    idx["host_single"] = single.node_idx.cpu().numpy()
    _check(np.array_equal(idx["host_single"], idx["host_rounds"]),
           "sharded hostname-mode rounds diverged from the single-device scan")
    return {"node_idx": idx,
            "ranks": [[{k: v for k, v in rec.items() if k != "result"} for rec in r]
                      for r in ranks]}
