"""The port's plain fused step against the Pallas kernel (interpret mode).

``kubernetes_tpu_torch.ops.fused_step.fused_step_ref`` has the Pallas
kernel's signature; both get the same seeded numpy inputs and every output
must be exactly equal (floats compared by bit pattern). The nonzero
requests stay below 2**24, where the Pallas kernel's convert-then-add and
the scan's add-then-convert (which the port follows) agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import pallas_step
from kubernetes_tpu_torch import interop
from kubernetes_tpu_torch.ops import fused_step

R, W = 6, 16
WEIGHTS = np.array([[1.0, 1.0, 3.0, 2.0, 1.0, 0.0, 0.0, 0.0]], np.float32)


def _random_case(rng, n, boundary=False, ties=False):
    if boundary:
        # capacities where (cap - r) * 100 / cap lands on integers
        caps = np.array([3, 7, 1000, 4, 5, 8, 10, 100, 25, 50, 0], np.int32)
        cap = caps[rng.randint(len(caps), size=(2, n))]
        frac = rng.randint(0, 5, size=(2, n))
        nz2 = (cap * frac) // 4
        alloc = np.concatenate([cap, rng.randint(0, 100, size=(R - 2, n))]).astype(np.int32)
        nz = np.concatenate([nz2, rng.randint(0, 50, size=(R - 2, n))]).astype(np.int32)
        preq = rng.choice([0, 1, 2, 5], size=(R, 1)).astype(np.int32)
    else:
        alloc = rng.randint(0, 1 << 20, size=(R, n)).astype(np.int32)
        nz = (alloc * rng.uniform(0, 1.1, size=(R, n))).astype(np.int32)
        preq = rng.randint(0, 1 << 16, size=(R, 1)).astype(np.int32)
        preq[rng.randint(R)] = 0
    req = (nz * rng.uniform(0.5, 1.0, size=nz.shape)).astype(np.int32)
    ports = np.where(rng.uniform(size=(W, n)) < 0.05,
                     rng.randint(0, 1 << 31, size=(W, n)), 0).astype(np.uint32)
    pbits = np.zeros((W, 1), np.uint32)
    pbits[rng.randint(W), 0] = np.uint32(1) << np.uint32(rng.randint(32))
    static_ok = rng.uniform(size=(1, n)) < 0.8
    taint = rng.randint(0, 3, size=(1, n)).astype(np.float32)
    aff = rng.choice([0, 2, 5, 7], size=(1, n)).astype(np.float32)
    img = rng.choice([0, 0, 10, 42], size=(1, n)).astype(np.float32)
    if ties:
        jitter = np.zeros((1, n), np.float32)
    else:
        jitter = (rng.randint(0, 1 << 24, size=(1, n)).astype(np.float32)
                  * np.float32(0.5 / (1 << 24)))
    return dict(alloc=alloc, req=req, nz=nz, ports=ports, preq=preq,
                pnz=np.maximum(preq, 1).astype(np.int32), pbits=pbits,
                static_ok=static_ok, taint=taint, aff=aff, img=img, jitter=jitter)


def _run_both(c, p_valid=1):
    pv = np.array([[p_valid]], np.int32)
    jax_out = pallas_step.fused_step(
        jnp.asarray(c["alloc"]), jnp.asarray(c["req"]), jnp.asarray(c["nz"]),
        jnp.asarray(c["ports"]), jnp.asarray(c["preq"]), jnp.asarray(c["pnz"]),
        jnp.asarray(c["pbits"]), jnp.asarray(c["static_ok"]), jnp.asarray(c["taint"]),
        jnp.asarray(c["aff"]), jnp.asarray(c["img"]), jnp.asarray(c["jitter"]),
        jnp.asarray(pv), jnp.asarray(WEIGHTS), interpret=True)

    def t(a):
        return torch.from_numpy(np.array(a))

    port_out = fused_step.fused_step_ref(
        t(c["alloc"]), t(c["req"]), t(c["nz"]), t(c["ports"].view(np.int32)),
        t(c["preq"]), t(c["pnz"]), t(c["pbits"].view(np.int32)), t(c["static_ok"]),
        t(c["taint"]), t(c["aff"]), t(c["img"]), t(c["jitter"]), t(pv), t(WEIGHTS))
    return [np.asarray(x) for x in jax_out], [x.numpy() for x in port_out]


def _assert_same(jax_out, port_out):
    names = ("req", "nz", "ports", "idx", "best", "any_feasible", "fit_ok", "ports_ok")
    for name, a, b in zip(names, jax_out, port_out):
        if name == "ports":
            b = b.view(np.uint32)
        if name == "best":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", ["random", "boundary", "ties"])
@pytest.mark.parametrize("n", [128, 256])
def test_fused_step_ref_matches_pallas_interpret(case, n):
    rng = np.random.RandomState(n + len(case))
    c = _random_case(rng, n, boundary=case == "boundary", ties=case == "ties")
    # chain several steps, each on the carry the previous one evolved
    for _ in range(4):
        jax_out, port_out = _run_both(c)
        _assert_same(jax_out, port_out)
        c["req"], c["nz"], c["ports"] = jax_out[0], jax_out[1], jax_out[2]


def test_fused_step_ref_padded_pod_commits_nothing():
    rng = np.random.RandomState(3)
    c = _random_case(rng, 128)
    jax_out, port_out = _run_both(c, p_valid=0)
    _assert_same(jax_out, port_out)
    assert port_out[3][0, 0] == -1
    np.testing.assert_array_equal(port_out[0], c["req"])


def test_batch_ref_nominated_node_wins_when_feasible():
    """The scan's nominated fast path: +1e7 on the nominated slot."""
    rng = np.random.RandomState(5)
    n, p = 128, 4
    c = _random_case(rng, n)
    t = torch.from_numpy
    static_ok = torch.ones((p, n), dtype=torch.bool)
    args = (t(c["alloc"].T.copy()), t(c["req"].T.copy()) * 0, t(c["nz"].T.copy()) * 0,
            torch.zeros((n, W), dtype=torch.int32),
            torch.ones((p, R), dtype=torch.int32), torch.ones((p, R), dtype=torch.int32),
            torch.zeros((p, W), dtype=torch.int32), static_ok,
            torch.zeros((p, n), dtype=torch.int8), torch.zeros((p, n)),
            torch.zeros((p, n)), torch.zeros((p, n)), torch.zeros((p, n)))
    alloc = args[0]
    ok = int(torch.nonzero(torch.all(alloc > 0, dim=1))[-1])
    nominated = torch.tensor([-1, ok, -1, ok], dtype=torch.int32)
    weights = interop.weights_from_dict({})
    assert list(weights) == WEIGHTS[0, :5].tolist()
    out = fused_step.fused_step_batch_ref(*args, nominated, torch.ones(p, dtype=torch.bool),
                                          weights)
    assert int(out.node_idx[1]) == ok and int(out.node_idx[3]) == ok
