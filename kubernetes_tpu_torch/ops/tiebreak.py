"""Deterministic seeded tie-break, bit-for-bit the JAX package's
(``kubernetes_tpu/ops/tiebreak.py``; the reference's reservoir uniform
tie-break is pkg/scheduler/schedule_one.go:709-730).

The reference breaks score ties with an unseeded uniform draw, which makes
exact-replay parity between two schedulers unmeasurable. Here both paths
derive the SAME per-(pod, attempt, node) 32-bit key:

    key(p, n) = mix32(pod_seed(pod_key, attempts) ^ fnv1a32(node_name))

and pick the tied node with the LARGEST key — a uniform choice over the tie
set (mix32 is a bijective avalanche permutation), but reproducible. The
device adds the same key, scaled into [0, 0.5), onto each node's score as
jitter: for exactly-tied scores argmax-by-jitter == max-by-key, so the
batched path and the oracle land the same node.

Node keys hash the node NAME (not the slot), so values do not depend on
the slot layout.
"""

from __future__ import annotations

import numpy as np
import torch

_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)
_GOLDEN = np.uint32(0x9E3779B9)
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)

# jitter strictly below 0.5: integer plugin scores differ by ≥ 1, so the
# tie-break can never flip a non-tie (same bound the old uniform draw used)
JITTER_SCALE = np.float32(0.5 / (1 << 24))


def fnv1a32(s: str) -> np.uint32:
    """FNV-1a over the UTF-8 bytes — stable across processes (unlike hash())."""
    h = int(_FNV_OFFSET)
    prime = int(_FNV_PRIME)
    for b in s.encode("utf-8"):
        h = ((h ^ b) * prime) & 0xFFFFFFFF
    return np.uint32(h)


def mix32(x):
    """Murmur3 finalizer (avalanche bijection) — scalar or ndarray. Scalars
    run in masked Python ints (numpy warns on intended u32 wraparound)."""
    if np.ndim(x) == 0:
        v = int(x) & 0xFFFFFFFF
        v ^= v >> 16
        v = (v * int(_M1)) & 0xFFFFFFFF
        v ^= v >> 13
        v = (v * int(_M2)) & 0xFFFFFFFF
        v ^= v >> 16
        return np.uint32(v)
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * _M1
        x = x ^ (x >> np.uint32(13))
        x = x * _M2
        x = x ^ (x >> np.uint32(16))
    return x


def pod_seed(pod_key: str, attempts: int = 0) -> np.uint32:
    """Per-(pod, scheduling attempt) seed: fresh tie-break draw each retry,
    exactly reproducible by anyone holding (pod key, attempt count)."""
    return mix32(int(fnv1a32(pod_key)) ^ ((attempts * int(_GOLDEN)) & 0xFFFFFFFF))


def name_hash(node_name: str) -> np.uint32:
    return fnv1a32(node_name)


def tie_key(seed: np.uint32, node_name_hash: np.uint32) -> int:
    """Oracle-side scalar: the tied node with the largest key wins."""
    return int(mix32(np.uint32(seed) ^ np.uint32(node_name_hash)))


def _mul32(x, m: int):
    """(x * m) mod 2**32 for an int64 tensor x in [0, 2**32): split into
    16-bit halves so no int64 product overflows."""
    lo = (x & 0xFFFF) * m
    hi = ((x >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & 0xFFFFFFFF


def jitter_table(tie_seed, node_name_hash):
    """Device-side [P, N] float32 jitter in [0, 0.5): monotone in tie_key, so
    score-tied argmax == oracle's max-by-key. Bit-equal to the JAX package's
    ``jitter_table``.

    ``tie_seed`` [P] and ``node_name_hash`` [N] are int32 tensors carrying
    uint32 bits; the murmur3 finalizer runs in int64 masked to 32 bits.

    Precision bound: only the top 24 hash bits survive the float32 mantissa,
    so among a K-node pure-tie set the device argmax can disagree with the
    oracle's full-32-bit max with probability about K/2**16."""
    x = ((tie_seed.to(torch.int64) & 0xFFFFFFFF)[:, None]
         ^ (node_name_hash.to(torch.int64) & 0xFFFFFFFF)[None, :])
    x = x ^ (x >> 16)
    x = _mul32(x, int(_M1))
    x = x ^ (x >> 13)
    x = _mul32(x, int(_M2))
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * float(JITTER_SCALE)  # a power of two: exact


def seeds_for(qps) -> np.ndarray:
    """[len(qps)] uint32 tie-break seeds of queued pods: each pod's key and
    its queue ``attempts`` (1 at the first pop), as the scheduler loop
    encodes its batches (``kubernetes_tpu/ops/tiebreak.py:109``)."""
    return np.asarray([pod_seed(qp.pod.key(), qp.attempts) for qp in qps], np.uint32)
