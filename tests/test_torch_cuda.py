"""The CUDA fused-step kernel against its plain PyTorch version, on the card.

Marked ``cuda``: without a CUDA device these tests skip. They import no JAX,
so they also run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops import fused_step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def _batch(rng, p, n, r=6, w=16):
    alloc = rng.choice([0, 3, 7, 1000, 4000, 32000], size=(n, r)).astype(np.int32)
    nz = (alloc * rng.uniform(0, 1.1, size=(n, r))).astype(np.int32)
    ports = np.where(rng.uniform(size=(n, w)) < 0.05,
                     rng.randint(0, 1 << 31, size=(n, w)), 0).astype(np.int32)
    p_req = rng.choice([0, 1, 2, 100, 900], size=(p, r)).astype(np.int32)
    p_bits = np.zeros((p, w), np.int32)
    for i in range(0, p, 3):
        p_bits[i, rng.randint(w)] = 1 << rng.randint(31)
    jitter = np.where(rng.uniform(size=(p, n)) < 0.5, 0.0,
                      rng.randint(0, 1 << 24, size=(p, n)) * (0.5 / (1 << 24)))
    nominated = np.full(p, -1, np.int32)
    nominated[1] = n // 2
    valid = np.ones(p, bool)
    valid[-2:] = False
    static_ok = (rng.uniform(size=(p, n)) < 0.9) & valid[:, None]
    return dict(
        alloc=alloc, requested=(nz * 0.9).astype(np.int32), nonzero=nz, ports=ports,
        p_req=p_req, p_nz=np.maximum(p_req, 1), p_bits=p_bits, static_ok=static_ok,
        static_ff=np.where(static_ok, 0, rng.randint(1, 5, size=(p, n))).astype(np.int8),
        taint=rng.randint(0, 3, size=(p, n)).astype(np.float32),
        aff=rng.choice([0, 2, 5], size=(p, n)).astype(np.float32),
        img=rng.choice([0, 0, 42], size=(p, n)).astype(np.float32),
        jitter=jitter.astype(np.float32), nominated=nominated, p_valid=valid)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1000, 5120])
def test_kernel_matches_plain_version(cuda, n):
    rng = np.random.RandomState(n)
    d = _batch(rng, 32, n)
    args = [torch.from_numpy(np.ascontiguousarray(d[k])).to(cuda) for k in (
        "alloc", "requested", "nonzero", "ports", "p_req", "p_nz", "p_bits",
        "static_ok", "static_ff", "taint", "aff", "img", "jitter", "nominated",
        "p_valid")]
    weights = (1.0, 1.0, 3.0, 2.0, 1.0)
    before = fused_step.LAUNCHES
    got = fused_step.fused_step_batch(*args, weights)
    torch.cuda.synchronize()
    assert fused_step.LAUNCHES == before + 1
    want = fused_step.fused_step_batch_ref(*args, weights)
    for name, a, b in zip(got._fields, got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    assert int(got.node_idx[-1]) == -1  # a padded pod commits nothing
