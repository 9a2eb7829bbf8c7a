"""Dynamic Resource Allocation structured parameters: the one selector
model shared by the commit-time claim checks
(framework/plugins/dynamicresources.py) and the batched claim-feasibility
mask (backend/batch.py claim_feasibility_mask), so host and device agree by
construction. Own copy of ``kubernetes_tpu/api/dra.py``.

A selector map is ``attribute key -> expression``:

    {"tpu.dev/cores": ">=4", "tpu.dev/gen": "v5", "tpu.dev/pcie": "!=1"}

Expressions are ``[op]operand`` with op one of ``== != >= > <= <`` (bare
operand means equality); integer operands parse to ints, anything else is a
string. Node attribute values (NodeStatus.device_attributes) are ints or
strings. Matching semantics (identical on host and device):

  * an absent attribute never matches, under ANY operator;
  * ==/!= require the same value type (int vs string) — a type mismatch is
    a non-match, not an error;
  * ordering operators match only int attribute against int operand.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

# selector op codes — also the device encoding (backend/batch.py); -1 pads
OP_EQ = 0
OP_NE = 1
OP_GE = 2
OP_GT = 3
OP_LE = 4
OP_LT = 5

_OP_TOKENS = (
    (">=", OP_GE), ("<=", OP_LE), ("==", OP_EQ), ("!=", OP_NE),
    (">", OP_GT), ("<", OP_LT),
)

# attribute value kinds — the device encoding's type tag (0 = absent)
KIND_ABSENT = 0
KIND_INT = 1
KIND_STR = 2

_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def attr_kind_val(value) -> Tuple[int, object]:
    """Canonical (kind, value) for one published attribute: ints clamp to
    int32 (the device cell width), strings pass through, anything else is
    treated as absent (bools included — ambiguous between the two domains)."""
    if isinstance(value, bool) or value is None:
        return KIND_ABSENT, 0
    if isinstance(value, int):
        return KIND_INT, min(max(value, _INT32_MIN), _INT32_MAX)
    if isinstance(value, str):
        return KIND_STR, value
    return KIND_ABSENT, 0


@dataclasses.dataclass(frozen=True)
class DeviceSelector:
    """One parsed attribute requirement: ``key op operand`` with the operand
    already typed (operand_kind KIND_INT/KIND_STR)."""

    key: str
    op: int = OP_EQ
    operand_kind: int = KIND_INT
    operand: object = 0

    def matches(self, attrs: Mapping[str, object]) -> bool:
        kind, val = attr_kind_val(attrs.get(self.key)) if attrs else (KIND_ABSENT, 0)
        if kind == KIND_ABSENT:
            return False
        if self.op == OP_EQ:
            return kind == self.operand_kind and val == self.operand
        if self.op == OP_NE:
            return kind == self.operand_kind and val != self.operand
        if kind != KIND_INT or self.operand_kind != KIND_INT:
            return False
        if self.op == OP_GE:
            return val >= self.operand
        if self.op == OP_GT:
            return val > self.operand
        if self.op == OP_LE:
            return val <= self.operand
        return val < self.operand  # OP_LT


def _typed_operand(tok: str) -> Tuple[int, object]:
    try:
        return KIND_INT, min(max(int(tok, 10), _INT32_MIN), _INT32_MAX)
    except ValueError:
        return KIND_STR, tok


def parse_selector(key: str, expr) -> DeviceSelector:
    """One map entry -> DeviceSelector. Non-string expressions (YAML ints)
    mean equality on that value."""
    if not isinstance(expr, str):
        kind, val = attr_kind_val(expr)
        if kind == KIND_ABSENT:
            kind, val = KIND_STR, str(expr)
        return DeviceSelector(key, OP_EQ, kind, val)
    s = expr.strip()
    for tok, op in _OP_TOKENS:
        if s.startswith(tok):
            kind, val = _typed_operand(s[len(tok):].strip())
            return DeviceSelector(key, op, kind, val)
    kind, val = _typed_operand(s)
    return DeviceSelector(key, OP_EQ, kind, val)


def parse_selectors(selectors: Mapping[str, object]) -> List[DeviceSelector]:
    return [parse_selector(k, v) for k, v in sorted((selectors or {}).items())]


# ---------------------------------------------------------------------------
# pod -> claims resolution (shared by plugin, controller, batched builder)


def effective_claim_name(pod_name: str, prc) -> str:
    """The ResourceClaim object name a PodResourceClaim resolves to:
    claim_name when direct, else the controller-generated ``<pod>-<entry>``."""
    return prc.claim_name if prc.claim_name else f"{pod_name}-{prc.name}"


def claim_refs_for_pod(pod) -> List[Tuple[str, str]]:
    """[(entry name, claim object key)] for every pod.spec.resourceClaims
    entry."""
    return [
        (prc.name, f"{pod.meta.namespace}/{effective_claim_name(pod.meta.name, prc)}")
        for prc in pod.spec.resource_claims
    ]


def selectors_for_claim(store, claim) -> Tuple[List[DeviceSelector], Optional[str]]:
    """Merged class + claim selectors (claim entries override the class's on
    the same key, resourceclaim/structured semantics); (selectors, error).
    A missing ResourceClass is an error — the claim cannot be evaluated."""
    merged: Dict[str, object] = {}
    if claim.resource_class_name:
        rc = store.get_object("ResourceClass", claim.resource_class_name)
        if rc is None:
            return [], f'resourceclass "{claim.resource_class_name}" not found'
        merged.update(rc.selectors or {})
    merged.update(claim.selectors or {})
    return parse_selectors(merged), None
