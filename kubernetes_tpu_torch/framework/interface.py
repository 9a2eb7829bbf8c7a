"""The plugin contract of the port's framework (``kubernetes_tpu/framework/
interface.py``; pkg/scheduler/framework/interface.go).

A plugin is an object with ``name()`` and one method per extension point
it implements; ``Framework`` (``framework/runtime.py``) keeps an entry of a
profile's plugin list only when its object has the point's method
(``POINT_METHODS``), as the JAX runtime does, so a MultiPoint entry joins
exactly the points its plugin implements. The methods, as the runtime
calls them (``state`` is the pod's ``runtime.PreFilterState``, the cycle
state: the in-tree plugins keep their results in its fields, any other
plugin in ``state.data`` under its name):

  * queue_sort: ``less(a, b)`` over QueuedPodInfos; a ``sort_key(qp)``
    method, when present, is the queue's heap key (PrioritySort's order
    otherwise);
  * pre_enqueue: ``pre_enqueue(pod)``: None to admit, else the refusal;
  * pre_filter: ``pre_filter(state, pod)`` -> (the node names the pod is
    restricted to, or None for every node; None, or the ``Fail``); the
    optional ``add_pod(state, pod, other, node_info)`` and ``remove_pod``
    are its extensions, which the preemption dry run calls;
  * filter: ``filter(state, pod, node_info)`` -> None, or the ``Fail``;
  * post_filter: ``post_filter(pod, hints, unresolvable, state)`` -> (the
    node the pod is nominated to, or None; the reason or None); ``state`` is
    the sequential cycle's PreFilter state (or the PreFilter's ``Fail``;
    None on the batch path);
  * pre_score: ``pre_score(state, pod, feasible)`` over the feasible
    NodeInfos;
  * score: ``score_node(state, pod, node_info)`` -> int in [0, 100] after
    the optional ``normalize_score(state, pod, scores)`` (node name ->
    raw score, rewritten in place);
  * reserve: ``reserve(state, pod, node_name)`` -> None or the refusal,
    and ``unreserve(state, pod, node_name)``;
  * permit: ``permit(state, pod, node_name)`` -> ``PermitVerdict``;
  * pre_bind: ``pre_bind(state, pod, node_name)`` -> None or the refusal;
  * bind: ``bind(state, pod, node_name)`` -> None, the error, or ``SKIP``
    to leave the pod to the next Bind plugin;
  * post_bind: ``post_bind(state, pod, node_name)``; a
    ``post_bind_batch(pods)`` method, when present, takes a committed
    batch's bound pods in one call;
  * ``events_to_register()``, optional: the cluster events that may make
    a pod the plugin failed schedulable (a plugin without it is moved by
    every event).

An out-of-tree plugin needs only ``name()``, its points' methods, and
``unschedulable`` below (or a ``Fail`` that is unresolvable) to build a
Filter's failure.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

EXTENSION_POINTS = (
    "queue_sort", "pre_enqueue", "pre_filter", "filter", "post_filter",
    "pre_score", "score", "reserve", "permit", "pre_bind", "bind", "post_bind",
)

# extension point -> the method a plugin implements to join it
POINT_METHODS = {
    "queue_sort": "less",
    "pre_enqueue": "pre_enqueue",
    "pre_filter": "pre_filter",
    "filter": "filter",
    "post_filter": "post_filter",
    "pre_score": "pre_score",
    "score": "score_node",
    "reserve": "reserve",
    "permit": "permit",
    "pre_bind": "pre_bind",
    "bind": "bind",
    "post_bind": "post_bind",
}

# a Permit verdict: (None, None) allow, (None, seconds) wait, (reason, None) reject
PermitVerdict = Tuple[Optional[str], Optional[float]]


class _Skip:
    """A Bind plugin's answer for a pod it does not bind (Status Skip)."""

    def __repr__(self) -> str:
        return "SKIP"


SKIP = _Skip()


class Fail(NamedTuple):
    """A failed check: the plugin, its reason, and whether its status is
    UnschedulableAndUnresolvable (preemption cannot help on that node)."""

    plugin: str
    reason: str
    unresolvable: bool


def unschedulable(reason: str, plugin: str = "") -> Fail:
    """A failure preemption may resolve (the runtime names the plugin)."""
    return Fail(plugin, reason, False)
