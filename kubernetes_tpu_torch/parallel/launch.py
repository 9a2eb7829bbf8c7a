"""One process per rank: the launcher of the sharded program.

``run_ranks(fn, world, ...)`` spawns ``world`` processes (the ``spawn``
start method), joins them into one ``torch.distributed`` group through a
``FileStore`` in a temporary directory (no TCP port, so concurrent test
workers never collide), calls ``fn(mesh, *args)`` on every rank with that
rank's ``NodeMesh`` and returns each rank's result, in rank order. ``fn``
must be importable (a module-level function of the port), its arguments
and result picklable; tensors should come back on the host.

Nothing hides a failure: a rank that raises or dies fails the call, and
ranks still running past ``timeout_s`` are killed and the call raises. The
backend defaults to ``nccl`` for one CUDA rank and ``gloo`` otherwise (NCCL
cannot put two ranks on one card); there is no switch to another backend
when one fails to start.

``schedule_cases`` is the rank program the tests and ``chip_smoke.py`` run
through it: encoded batches (numpy field dicts) through
``make_sharded_schedule_fn``, gathered, with their times and collective
counts.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import fused_step
from ..ops.schema import ExprTable, NodeTensors, PodBatch, TopoBatch, TopoCounts
from ..utils.device import DeviceLike, resolve_device
from .mesh import (NodeMesh, gather_result, make_node_mesh, make_sharded_schedule_fn,
                   shard_node_tensors, shard_topo_counts)


def default_backend(device: torch.device, world: int) -> str:
    """``nccl`` for one rank on the card, ``gloo`` otherwise."""
    return "nccl" if device.type == "cuda" and world == 1 else "gloo"


def _rank_main(fn, rank: int, world: int, backend: str, device: str, tmp: str,
               results, timeout_s: float) -> None:
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        else:
            torch.cuda.set_device(dev.index or 0)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_node_mesh(dev), *args)
            if world > 1:
                dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out))
    except BaseException:  # noqa: BLE001 - every failure goes back to the caller
        results.put(("err", rank, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: Optional[str] = None,
              device: DeviceLike = None, args: Sequence[Any] = (),
              timeout_s: float = 300.0) -> List[Any]:
    """``[fn(mesh_r, *args) for r in range(world)]``, each call in a process
    of its own joined into one group of ``world`` ranks over ``backend``
    (None: ``default_backend``) on ``device`` (None: the CUDA card, which
    raises without one; every rank uses the same device). Raises when a
    rank raises or exits without a result, and when the ranks are not done
    within ``timeout_s`` seconds; every process is gone when it returns."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev, world)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ktpu-ranks-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, backend, str(dev), tmp, results, timeout_s))
             for rank in range(world)]
    started = []
    try:
        # the arguments go through a file: the spawn pipe would block each
        # start until the child has imported the port to read them
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for p in procs:
            p.start()
            started.append(p)
        out: List[Any] = [None] * world
        done = set()
        deadline = time.monotonic() + timeout_s
        while len(done) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - done)} of {world} not "
                                   f"done after {timeout_s} s")
            try:
                kind, rank, payload = results.get(timeout=min(remaining, 0.5))
            except queue_mod.Empty:
                for rank, p in enumerate(procs):
                    if rank not in done and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {rank} exited with code {p.exitcode}")
                continue
            if kind == "err":
                raise RuntimeError(f"rank {rank} of {world} ({backend}, {dev}) raised:\n"
                                   f"{payload}")
            out[rank] = payload
            done.add(rank)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return out
    finally:
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def result_to_numpy(res) -> dict:
    """A BatchResult's fields as numpy arrays (the static masks a dict of
    them; None stays None)."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if isinstance(v, dict):
            out[f.name] = {k: t.cpu().numpy() for k, t in v.items()}
        else:
            out[f.name] = None if v is None else v.cpu().numpy()
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def schedule_cases(mesh: NodeMesh, cases: Sequence[dict]) -> List[dict]:
    """Rank program: each case of ``cases`` on this rank. A case holds
    ``pb``, ``et``, ``nt``, ``tc`` and ``tb`` (the global encoded batch as
    numpy field dicts, ``to_numpy()`` of the port's dataclasses), ``kw``
    (``make_sharded_schedule_fn``'s keywords) and optionally ``repeat``
    (timed runs after the first, default 0). Returns per case: ``result``
    (the gathered BatchResult as numpy, on rank 0; None elsewhere), ``ms``
    (host ms of each run, the first included, the device synchronized
    around each), ``collectives`` and ``collective_bytes`` of the first
    run, ``fused_launches`` (the fused kernel's launches on this rank over
    every run of the case: the sharded program takes the scan or the
    rounds, so 0), ``peak_bytes`` (the CUDA allocator's peak on this rank,
    None on the CPU)."""
    out = []
    dev = mesh.device
    for case in cases:
        pb = PodBatch.from_numpy(case["pb"], dev)
        et = ExprTable.from_numpy(case["et"], dev)
        tb = TopoBatch.from_numpy(case["tb"], dev)
        nt = shard_node_tensors(NodeTensors.from_numpy(case["nt"], "cpu"), mesh)
        tc = shard_topo_counts(TopoCounts.from_numpy(case["tc"], "cpu"), mesh)
        fn = make_sharded_schedule_fn(mesh, **case.get("kw", {}))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ms, counts, res = [], None, None
        launches = fused_step.LAUNCHES
        for i in range(1 + int(case.get("repeat", 0))):
            mesh.reset_counters()
            _sync(dev)
            t0 = time.perf_counter()
            r = fn(pb, et, nt, tc, tb)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                res = r
                counts = (mesh.collectives, mesh.collective_bytes)
        full = gather_result(res, mesh, fn.topo_mode)
        out.append({"result": result_to_numpy(full) if mesh.rank == 0 else None, "ms": ms,
                    "collectives": counts[0], "collective_bytes": counts[1],
                    "fused_launches": fused_step.LAUNCHES - launches,
                    "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None)})
    return out


def case_fields(pb, et, nt, tc, tb, **kw) -> dict:
    """A ``schedule_cases`` case from the port's encoded dataclasses (on
    any device) and ``make_sharded_schedule_fn``'s keywords (``repeat``
    goes through too)."""
    repeat = kw.pop("repeat", 0)
    return {"pb": pb.to_numpy(), "et": et.to_numpy(), "nt": nt.to_numpy(),
            "tc": tc.to_numpy(), "tb": tb.to_numpy(), "kw": kw, "repeat": repeat}


def result_diff(got: dict, want: dict) -> List[str]:
    """The fields of two ``result_to_numpy`` dicts that differ: shapes and
    values exactly, floats by their bits; a field None in one only counts
    as a difference. For the tests and ``chip_smoke.py``."""
    bad = []
    for name, a in got.items():
        b = want.get(name)
        pairs = ([(f"{name}.{k}", a[k], b.get(k)) for k in a] if isinstance(a, dict)
                 else [(name, a, b)])
        for label, x, y in pairs:
            if x is None or y is None:
                if (x is None) != (y is None):
                    bad.append(label)
            elif x.shape != y.shape or x.dtype != y.dtype or x.tobytes() != y.tobytes():
                bad.append(label)
    return bad
