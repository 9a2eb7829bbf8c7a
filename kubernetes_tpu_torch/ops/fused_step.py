"""The fused per-pod commit step, scanned over a pod batch.

Replaces the Pallas TPU kernel ``kubernetes_tpu/ops/pallas_step.py:
_step_kernel`` (called through ``fused_step``, scanned per pod by
``lax.scan`` in ``kubernetes_tpu/backend/batch.py:schedule_batch_core``).
For each pod in order, against all N nodes: resource fit (``req == 0``
always fits), host-port conflict, ``feasible = static_ok & fit & ports_ok``,
LeastAllocated + BalancedAllocation on the evolving nonzero-requested state,
DefaultNormalizeScore of the raw taint (reversed) and affinity scores over
the feasible set, the weighted total plus the image score, the jittered
masked argmax (first maximum wins), and the commit of the winner's request,
nonzero request and port bits to its node.

Two forms of one function:

* ``fused_step_batch_ref`` — plain PyTorch, a loop over pods. Float32 only,
  in the JAX evaluation order, so its floats have the JAX program's bits.
  ``fused_step_ref`` is its one-pod form with the Pallas kernel's signature.
* ``fused_step_batch`` — the wrapper. On CPU tensors it runs the plain
  version; on CUDA tensors it launches ``csrc/fused_step.cu`` (one launch per
  batch, the counterpart of ``lax.scan`` over ``pallas_call``) or raises.
  The kernel is one cluster of ``CLUSTER`` thread blocks of ``_THREADS``
  threads, each block owning a contiguous slice of the node axis; the pods
  run in order, with two cluster barriers per pod. In each block warp 0
  leads the reductions and the other warps own the nodes.

Semantics follow the XLA scan ``step`` where the two JAX paths differ:
the nominated node gets ``+1e7`` (the Pallas kernel has no nominated input),
and the nonzero request is added in int32 before the float conversion (the
Pallas kernel converts first; the two agree below 2**24).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

import torch

from ..backend import telemetry

NEG_INF = -(2.0 ** 30)  # not -inf: padded nodes must never win, yet stay ordered
NOMINATED_BONUS = 1e7   # the nominated node wins outright when feasible

# weight order of the kernel (and of the Pallas kernel's [1, 8] row)
WEIGHT_ORDER = ("NodeResourcesFit", "NodeResourcesBalancedAllocation",
                "TaintToleration", "NodeAffinity", "ImageLocality")

# kernel launches on CUDA tensors; comparisons and the plain version do not count
LAUNCHES = 0


class FusedStepOut(NamedTuple):
    node_idx: torch.Tensor       # [P] int32 winner slot, -1 = none
    best: torch.Tensor           # [P] float32 winner total (no jitter)
    any_feasible: torch.Tensor   # [P] bool (any feasible node AND pod valid)
    fit_ok: torch.Tensor         # [P, N] bool
    ports_ok: torch.Tensor       # [P, N] bool
    first_fail: torch.Tensor     # [P, N] int8 static table + 5 (ports) / 6 (fit)
    requested: torch.Tensor      # [N, R] int32 evolved carry
    nonzero: torch.Tensor        # [N, R] int32 evolved carry
    ports: torch.Tensor          # [N, W] int32 (uint32 bits) evolved carry


# ---------------------------------------------------------------- plain version


def _resource_scores(alloc2: torch.Tensor, nz_total: torch.Tensor):
    """(LeastAllocated, BalancedAllocation) over the cpu/memory columns,
    float32, in ``kubernetes_tpu/backend/batch.py:_resource_scores`` order."""
    cap0, cap1 = alloc2[..., 0], alloc2[..., 1]
    r0, r1 = nz_total[..., 0], nz_total[..., 1]
    zero = torch.zeros_like(cap0)
    la0 = torch.where((cap0 == 0) | (r0 > cap0), zero,
                      torch.floor((cap0 - r0) * 100.0 / torch.clamp_min(cap0, 1.0)))
    la1 = torch.where((cap1 == 0) | (r1 > cap1), zero,
                      torch.floor((cap1 - r1) * 100.0 / torch.clamp_min(cap1, 1.0)))
    least_alloc = torch.floor((la0 + la1) / 2.0)
    one = torch.ones_like(cap0)
    f0 = torch.where(cap0 == 0, one, torch.clamp_max(r0 / torch.clamp_min(cap0, 1.0), 1.0))
    f1 = torch.where(cap1 == 0, one, torch.clamp_max(r1 / torch.clamp_min(cap1, 1.0), 1.0))
    balanced = torch.floor((1.0 - torch.abs(f0 - f1) / 2.0) * 100.0)
    return least_alloc, balanced


def _normalize(raw: torch.Tensor, feasible: torch.Tensor, reverse: bool,
               dim=None, mesh=None) -> torch.Tensor:
    """DefaultNormalizeScore over the feasible set: of one pod's [N] raw
    scores, or with ``dim`` of every row of a [P, N] batch (the per-row max
    of the speculative rounds). One form for the scan and the rounds, whose
    outputs must match bit for bit. Under a ``mesh`` (``parallel/mesh.py``)
    the node axis is this rank's window and the maximum is taken over every
    rank (``kubernetes_tpu/backend/batch.py:265-280``), elementwise per row
    in the ``dim`` form."""
    masked = torch.where(feasible, raw, torch.zeros_like(raw))
    mx = torch.amax(masked) if dim is None else torch.amax(masked, dim=dim, keepdim=True)
    if mesh is not None:
        mx = mesh.all_reduce(mx, "max")
    scaled = torch.floor(raw * 100.0 / torch.clamp_min(mx, 1.0))
    if reverse:
        return torch.where(mx == 0, torch.full_like(scaled, 100.0), 100.0 - scaled)
    return torch.where(mx == 0, torch.zeros_like(scaled), scaled)


def _step(alloc, req, nz, ports, p_req, p_nz, p_bits, static_ok, taint, aff,
          img, jitter, nominated, p_valid, w: Sequence[float]):
    """One pod against every node, [N, ·] layout. Returns the evolved
    (req, nz, ports) and (idx, best, any_feasible, fit, ports_ok)."""
    n = alloc.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=alloc.device)
    free = alloc - req
    fit = torch.all((p_req[None, :] <= free) | (p_req[None, :] == 0), dim=1)
    ports_ok = ~torch.any((ports & p_bits[None, :]) != 0, dim=1)
    feasible = static_ok & fit & ports_ok

    nz_req = (nz[:, :2] + p_nz[None, :2]).to(torch.float32)
    least_alloc, balanced = _resource_scores(alloc[:, :2].to(torch.float32), nz_req)
    total = (
        w[0] * least_alloc
        + w[1] * balanced
        + w[2] * _normalize(taint, feasible, True)
        + w[3] * _normalize(aff, feasible, False)
        + w[4] * img
    )
    is_nom = (iota == nominated).to(torch.float32)
    eff = torch.where(feasible, total + jitter + is_nom * NOMINATED_BONUS,
                      torch.full_like(total, NEG_INF))
    idx = torch.argmax(eff).to(torch.int32)  # first maximum wins
    any_feasible = torch.any(feasible) & p_valid
    best = total[idx.long()]

    onehot = (iota == idx) & any_feasible
    req = req + onehot[:, None].to(req.dtype) * p_req[None, :]
    nz = nz + onehot[:, None].to(nz.dtype) * p_nz[None, :]
    ports = torch.where(onehot[:, None], ports | p_bits[None, :], ports)
    return (req, nz, ports), (idx, best, any_feasible, fit, ports_ok)


def fused_step_batch_ref(alloc, requested, nonzero, ports, p_req, p_nz, p_bits,
                         static_ok, static_ff, taint, aff, img, jitter,
                         nominated, p_valid, weights: Sequence[float]) -> FusedStepOut:
    """Plain PyTorch: the per-pod step in a Python loop, on any device.
    Shapes: node state [N, R] / [N, W]; pod rows [P, R] / [P, W]; [P, N] for
    static_ok (bool), static_ff (int8) and the float32 score rows; [P] for
    nominated (int32) and p_valid (bool); five weights in WEIGHT_ORDER."""
    w = [float(x) for x in weights]
    req, nz, prt = requested, nonzero, ports
    idxs, bests, anyfs, fits, pokss = [], [], [], [], []
    for p in range(p_req.shape[0]):
        (req, nz, prt), (idx, best, anyf, fit, poks) = _step(
            alloc, req, nz, prt, p_req[p], p_nz[p], p_bits[p], static_ok[p],
            taint[p], aff[p], img[p], jitter[p], nominated[p], p_valid[p], w)
        idxs.append(torch.where(anyf, idx, torch.full_like(idx, -1)))
        bests.append(best)
        anyfs.append(anyf)
        fits.append(fit)
        pokss.append(poks)
    fit_ok = torch.stack(fits)
    ports_ok = torch.stack(pokss)
    ff = torch.where((static_ff == 0) & ~ports_ok, torch.full_like(static_ff, 5), static_ff)
    ff = torch.where((ff == 0) & ~fit_ok, torch.full_like(ff, 6), ff)
    return FusedStepOut(torch.stack(idxs), torch.stack(bests), torch.stack(anyfs),
                        fit_ok, ports_ok, ff, req, nz, prt)


def fused_step_ref(alloc_t, req_t, nz_t, port_t, p_req, p_nz, p_bits,
                   static_ok, taint, aff, img, jitter, p_valid, weights) -> Tuple:
    """One pod, with the Pallas kernel's signature and layout ([R, N] /
    [W, N] node state, [R, 1] / [W, 1] pod rows, [1, N] rows, [1, 1]
    p_valid, [1, 8] weights) and no nominated node. Returns (req_t', nz_t',
    port_t', idx [1,1] int32, best [1,1] f32, any_feasible [1,1] int32,
    fit_ok [1,N] bool, ports_ok [1,N] bool)."""
    w = weights.reshape(-1)[:len(WEIGHT_ORDER)].tolist()
    nominated = torch.tensor(-1, dtype=torch.int32, device=alloc_t.device)
    (req, nz, prt), (idx, best, anyf, fit, poks) = _step(
        alloc_t.T, req_t.T, nz_t.T, port_t.T, p_req[:, 0], p_nz[:, 0],
        p_bits[:, 0], static_ok[0], taint[0], aff[0], img[0], jitter[0],
        nominated, p_valid.reshape(()) > 0, w)
    idx = torch.where(anyf, idx, torch.full_like(idx, -1))
    return (req.T.contiguous(), nz.T.contiguous(), prt.T.contiguous(),
            idx.reshape(1, 1), best.reshape(1, 1),
            anyf.to(torch.int32).reshape(1, 1), fit[None, :], poks[None, :])


# ---------------------------------------------------------------- CUDA kernel

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "fused_step.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CLUSTER = 8      # thread blocks of the one cluster, each owning ceil(N / 8) nodes
_THREADS = 1024  # threads per block; R + W <= _THREADS keeps the kernel's three
                 # shared [2R + W] pod rows within its dynamic shared memory


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused-step kernel is built with the "
                       "CUDA toolkit (set CUDA_HOME)")


def build_library(defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/fused_step.cu`` into ``_build/`` unless a library for
    this exact source and flag set is there already. Returns its path; the
    compiler's resource report lands beside it (``.ptxas.txt``). ``defines``
    are extra ``-D`` flags (``perf/kernel_phases.py`` builds the stamped
    kernel with ``-DKTPU_PHASE_STAMPS``)."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"fused_step-{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # the build ledger: this build, attributed to the dispatch open on this
    # thread (a library already in _build/ counts nothing)
    telemetry.compiled(time.perf_counter() - t0)
    return out


def load_library(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ktpu_fused_step_batch.argtypes = (
        [p] * 15 + [f] * 5 + [p] * 6 + [i] * 4 + [p])
    lib.ktpu_fused_step_batch.restype = ctypes.c_int
    lib.ktpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ktpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return load_library(build_library())


def fused_step_bytes(pods: int, n: int, r: int, w: int) -> int:
    """The bytes one launch must move at P=``pods``, N=``n``, R=``r``,
    W=``w``: each input of ``fused_step_batch`` read once (the int32
    [N, R] alloc / requested / nonzero and [N, W] ports, the int32 [P, R]
    requests and [P, W] port bits, the bool / int8 [P, N] static mask and
    first-fail ids, the four float32 [P, N] score planes, the int32 / bool
    [P] nominated node and validity) and each output written once (the
    [P] winner, score and feasibility, the bool [P, N] fit and port masks,
    the int8 [P, N] first-fail ids, the evolved [N, R] x2 and [N, W]
    carries)."""
    inputs = 4 * (3 * n * r + n * w + 2 * pods * r + pods * w) + 2 * pods * n \
        + 4 * 4 * pods * n + 5 * pods
    outputs = 9 * pods + 3 * pods * n + 4 * (2 * n * r + n * w)
    return inputs + outputs


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def fused_step_batch(alloc, requested, nonzero, ports, p_req, p_nz, p_bits,
                     static_ok, static_ff, taint, aff, img, jitter, nominated,
                     p_valid, weights: Sequence[float]) -> FusedStepOut:
    """The fused step over a batch: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (no fallback between the two). Inputs are
    never modified: the kernel evolves clones of the three carries."""
    global LAUNCHES
    args = (alloc, requested, nonzero, ports, p_req, p_nz, p_bits, static_ok,
            static_ff, taint, aff, img, jitter, nominated, p_valid, weights)
    device = alloc.device
    if device.type == "cpu":
        return fused_step_batch_ref(*args)
    if device.type != "cuda":
        raise ValueError(f"fused_step_batch runs on cpu or cuda, not {device}")
    n, r = alloc.shape
    pods, wds = p_req.shape[0], ports.shape[1]
    if n < 1 or r < 2 or r + wds > _THREADS:
        raise ValueError(f"unsupported shape N={n} R={r} W={wds}")
    for name, t, dtype, shape in (
            ("alloc", alloc, torch.int32, (n, r)),
            ("requested", requested, torch.int32, (n, r)),
            ("nonzero", nonzero, torch.int32, (n, r)),
            ("ports", ports, torch.int32, (n, wds)),
            ("p_req", p_req, torch.int32, (pods, r)),
            ("p_nz", p_nz, torch.int32, (pods, r)),
            ("p_bits", p_bits, torch.int32, (pods, wds)),
            ("static_ok", static_ok, torch.bool, (pods, n)),
            ("static_ff", static_ff, torch.int8, (pods, n)),
            ("taint", taint, torch.float32, (pods, n)),
            ("aff", aff, torch.float32, (pods, n)),
            ("img", img, torch.float32, (pods, n)),
            ("jitter", jitter, torch.float32, (pods, n)),
            ("nominated", nominated, torch.int32, (pods,)),
            ("p_valid", p_valid, torch.bool, (pods,))):
        _check(name, t, dtype, shape, device)
    w = [float(x) for x in weights]
    if len(w) != len(WEIGHT_ORDER):
        raise ValueError(f"expected {len(WEIGHT_ORDER)} weights, got {len(w)}")

    req_out, nz_out, ports_out = requested.clone(), nonzero.clone(), ports.clone()
    node_idx = torch.empty(pods, dtype=torch.int32, device=device)
    best = torch.empty(pods, dtype=torch.float32, device=device)
    any_feasible = torch.empty(pods, dtype=torch.bool, device=device)
    fit_ok = torch.empty((pods, n), dtype=torch.bool, device=device)
    ports_ok = torch.empty((pods, n), dtype=torch.bool, device=device)
    first_fail = torch.empty((pods, n), dtype=torch.int8, device=device)
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.ktpu_fused_step_batch(
        alloc.data_ptr(), req_out.data_ptr(), nz_out.data_ptr(), ports_out.data_ptr(),
        p_req.data_ptr(), p_nz.data_ptr(), p_bits.data_ptr(),
        static_ok.data_ptr(), static_ff.data_ptr(), taint.data_ptr(),
        aff.data_ptr(), img.data_ptr(), jitter.data_ptr(),
        nominated.data_ptr(), p_valid.data_ptr(),
        *w,
        node_idx.data_ptr(), best.data_ptr(), any_feasible.data_ptr(),
        fit_ok.data_ptr(), ports_ok.data_ptr(), first_fail.data_ptr(),
        pods, n, r, wds, stream)
    if rc != 0:
        raise RuntimeError("fused_step kernel launch failed: "
                           + lib.ktpu_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return FusedStepOut(node_idx, best, any_feasible, fit_ok, ports_ok,
                        first_fail, req_out, nz_out, ports_out)
