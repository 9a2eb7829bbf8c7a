"""String→id vocabularies for the device encoding.

The device never sees strings: label keys, (key,value) pairs, taints, ports,
images, extended-resource names and topology keys are interned host-side into
dense integer ids.  Ids are append-only and stable for the life of a Vocab, so
device-resident tensors indexed by id never need re-encoding when new strings
appear (they only need wider padding, handled by capacity doubling in the
backend).

Id 0 is reserved as "absent/invalid" in every vocab, which lets 0-padded
tensors be self-masking.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional


class Vocab:
    """Intern table. Id 0 is reserved; real ids start at 1.

    Ids are stable for as long as an item stays interned. ``release`` frees
    an id back to an internal free-list, so id space stays BOUNDED under
    churn (the elastic-cluster contract: removed nodes must not consume
    vocab forever). A release invalidates every cached encoding holding the
    freed id — the owner (ClusterEncoder) clears its template caches, and
    live rows never reference a freed id because reference-counted callers
    only release at refcount zero."""

    def __init__(self, name: str = ""):
        self.name = name
        self._ids: Dict[Hashable, int] = {}
        self._items: List[Hashable] = [None]  # index 0 reserved
        self._free: List[int] = []
        self.releases = 0

    def __len__(self) -> int:
        return len(self._items)

    def live(self) -> int:
        """Number of currently-interned items (capacity minus holes)."""
        return len(self._ids)

    def id(self, item: Hashable) -> int:
        """Intern ``item``, returning its stable id (allocating if new;
        freed ids are reused before the table grows)."""
        i = self._ids.get(item)
        if i is None:
            if self._free:
                i = self._free.pop()
                self._items[i] = item
            else:
                i = len(self._items)
                self._items.append(item)
            self._ids[item] = i
        return i

    def release(self, item: Hashable) -> Optional[int]:
        """Free ``item``'s id for reuse; returns the freed id (None if the
        item was never interned). Callers own the cache-invalidation
        contract described in the class docstring."""
        i = self._ids.pop(item, None)
        if i is not None:
            self._items[i] = None
            self._free.append(i)
            self.releases += 1
        return i

    def lookup(self, item: Hashable) -> int:
        """Id of ``item`` or 0 if never interned (no allocation)."""
        return self._ids.get(item, 0)

    def item(self, i: int) -> Hashable:
        return self._items[i]

    def ids(self, items: Iterable[Hashable]) -> List[int]:
        return [self.id(x) for x in items]
