"""Reaction hooks: inject failures/observations into store writes
(client-go testing/fixture.go's PrependReactor pattern); an own copy of
``kubernetes_tpu/testing/reactors.py``.

``with_reactors(store)`` wraps a ``Store``'s mutating methods so tests can
intercept verbs — return True to swallow the call, raise to inject an error,
return False/None to let the real method run:

    tracker = with_reactors(store)
    tracker.prepend("bind", lambda verb, args: raise_(Conflict("boom")))
"""

from __future__ import annotations

import functools
from typing import Callable, List, Tuple

VERBS = (
    "create_pod", "update_pod", "delete_pod", "bind",
    "create_node", "update_node", "delete_node",
    "create_lease", "update_lease", "bind_pv",
    "create_object", "update_object", "delete_object",
)


class ReactionError(Exception):
    """Raised by tests through a reactor to simulate server errors."""


class ReactorTracker:
    def __init__(self, store):
        self.store = store
        self.reactors: List[Tuple[str, Callable]] = []
        self.calls: List[Tuple[str, tuple]] = []  # observed (verb, args)
        self._wrap_all()

    def prepend(self, verb: str, fn: Callable) -> None:
        """fn(verb, args) -> truthy to swallow the call; may raise."""
        if verb != "*" and verb not in VERBS:
            raise ValueError(f"unknown verb {verb!r}")
        self.reactors.insert(0, (verb, fn))

    def _wrap_all(self) -> None:
        for verb in VERBS:
            original = getattr(self.store, verb)

            def make(verb=verb, original=original):
                @functools.wraps(original)
                def wrapped(*args, **kwargs):
                    self.calls.append((verb, args))
                    for want, fn in list(self.reactors):
                        if want in ("*", verb) and fn(verb, args):
                            return None
                    return original(*args, **kwargs)

                return wrapped

            setattr(self.store, verb, make())


def with_reactors(store) -> ReactorTracker:
    return ReactorTracker(store)


def raise_(exc: Exception):
    """Helper for lambda reactors: ``lambda v, a: raise_(ReactionError())``."""
    raise exc
