"""Resource quantities and their canonical integer encodings.

Mirrors the semantics of apimachinery's ``resource.Quantity``
(staging/src/k8s.io/apimachinery/pkg/api/resource) for the subset the scheduler
uses: parsing decimal/binary-SI strings, milli-value extraction for CPU, and
integer byte values for memory-like resources.

Canonical device units
----------------------
The device tensors store resources as int32.  To stay exact within int32
range each resource class gets a canonical unit, defined HERE and used by the
tensor encoder (the same units as the JAX package, so both encode alike):

  cpu                 -> millicores      (reference: Resource.MilliCPU, framework/types.go:414)
  memory              -> KiB, ceil       (reference keeps bytes in int64; int32 KiB is exact to 2 TiB)
  ephemeral-storage   -> MiB, ceil
  hugepages-*         -> MiB, ceil
  pods                -> count
  extended resources  -> integer value (counts; e.g. example.com/foo)
"""

from __future__ import annotations

import math
import re
from fractions import Fraction

# Resource names (subset of k8s.io/api/core/v1 const names).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
HUGEPAGES_PREFIX = "hugepages-"

_BINARY_SUFFIXES = {
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_DECIMAL_SUFFIXES = {
    "n": Fraction(1, 10**9), "u": Fraction(1, 10**6), "m": Fraction(1, 10**3),
    "": Fraction(1), "k": Fraction(10**3), "M": Fraction(10**6),
    "G": Fraction(10**9), "T": Fraction(10**12), "P": Fraction(10**15), "E": Fraction(10**18),
}

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+)([A-Za-z]{0,2})$")


def parse_quantity(value) -> Fraction:
    """Parse a quantity (string like '100m', '1Gi', '2', or a number) to a Fraction."""
    if isinstance(value, Fraction):
        return value
    if isinstance(value, (int, float)):
        return Fraction(value).limit_denominator(10**9)
    s = str(value).strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    num, suffix = m.groups()
    # Fraction parses decimal strings exactly ("2.0000000001" included):
    # never limit_denominator here
    base = Fraction(num)
    if suffix in _BINARY_SUFFIXES:
        return base * _BINARY_SUFFIXES[suffix]
    if suffix in _DECIMAL_SUFFIXES:
        return base * _DECIMAL_SUFFIXES[suffix]
    raise ValueError(f"invalid quantity suffix {suffix!r} in {value!r}")


def milli_value(value) -> int:
    """Quantity -> integer milli-units, rounding up (Quantity.MilliValue semantics)."""
    return math.ceil(parse_quantity(value) * 1000)


def int_value(value) -> int:
    """Quantity -> integer units, rounding up (Quantity.Value semantics)."""
    return math.ceil(parse_quantity(value))


_canonical_memo: dict = {}


def canonical(resource: str, value) -> int:
    """Canonical int for the device tensors. See module doc. Exact Fraction
    arithmetic; string results are memoized: workloads reuse a handful of
    quantity strings ("500m", "2Gi") across thousands of pods and this sits
    on the add_pod/encode hot path."""
    if isinstance(value, str):
        key = (resource, value)
        r = _canonical_memo.get(key)
        if r is not None:
            return r
        r = _canonical_py(resource, value)
        if len(_canonical_memo) < 1 << 20:
            _canonical_memo[key] = r
        return r
    return _canonical_py(resource, value)


def _canonical_py(resource: str, value) -> int:
    if resource == CPU:
        return milli_value(value)
    if resource == MEMORY:
        return math.ceil(parse_quantity(value) / 2**10)
    if resource == EPHEMERAL_STORAGE or resource.startswith(HUGEPAGES_PREFIX):
        return math.ceil(parse_quantity(value) / 2**20)
    # pods / extended resources: plain integer counts
    return int_value(value)


def is_extended(resource: str) -> bool:
    """Extended resources are domain-prefixed names (v1helper.IsExtendedResourceName)."""
    return "/" in resource and not resource.startswith("kubernetes.io/")


# Default requests applied by the *scoring* path only, mirroring
# util.GetNonzeroRequests (pkg/scheduler/util/pod_resources.go): pods with no
# request still "cost" a nominal amount so spreading scores stay meaningful.
DEFAULT_MILLI_CPU_REQUEST = 100          # 0.1 core
DEFAULT_MEMORY_REQUEST_KIB = 200 * 1024  # 200 MiB in KiB
