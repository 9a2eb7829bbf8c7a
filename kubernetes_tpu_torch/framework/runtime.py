"""The framework runtime: one ``Framework`` per profile, its filter chain
and its score runner, and the pod nominator.

An own copy of ``kubernetes_tpu/framework/runtime.py``
(pkg/scheduler/framework/runtime/framework.go). ``build_plugins`` builds a
profile's plugins as the JAX ``Framework`` does: one instance per plugin
name from the registry, an entry of the profile's list kept at a point only
when its instance has the point's method (``interface.POINT_METHODS``), a
name the registry does not know dropped. ``Framework`` holds the profile's
points and runs them in their order: the PreEnqueue gate, the PreFilters
and Filters (``FilterRunner``), PostFilter, the PreScores and Scores
(``ScoreRunner``), Reserve and Unreserve (the Reserve plugins in reverse),
Permit, PreBind, Bind (a plugin's ``SKIP`` passes the pod to the next) and
PostBind; its ``cluster_event_map`` and ``queue_sort_key`` feed the
scheduling queue. The bind tail's points run over a profile's items of a
batch (``reserve_batch``, ``permit_batch``, ``pre_bind_batch``,
``post_bind_batch``), item by item as JAX's batched executors do. The
default profile is the expansion of an empty config: ``DEFAULT_PLUGINS``
through the registry.

``FilterRunner`` runs the profile's PreFilters once per pod into a
``PreFilterState`` (the cycle state, which the Evaluator clones per dry
run): the first failure wins, and the node names the PreFilters restrict
the pod to must intersect (``:264-278``). ``gates=False`` leaves out the
host gates, QuotaAdmission and Coscheduling, which judge the tenant and
the gang, not the node. The Filters run in the profile's order, the first
failure wins (a ``Fail``: the plugin, the reason, and whether the status
is UnschedulableAndUnresolvable, which the sequential path's Diagnosis
records); the AddPod / RemovePod extensions of the PreFilter plugins move
the counts of PodTopologySpread and InterPodAffinity as the dry run adds
and removes pods; ``filter_with_nominated_pods`` is the two-pass filter of
``run_filter_plugins_with_nominated_pods`` (``:331-363``).

``ScoreRunner`` runs the PreScores and then the Scores, each normalized
before its weight applies (``:380-415``), in the JAX plugins' host
arithmetic.

Instrumentation (``:23-118``, ``:186-210``, ``:282-330``, ``:470-650``):
every point a pod runs on its own opens a ``framework.<point>`` span
(``profile``) with one ``plugin.<name>`` child (``extension_point``) per
plugin it runs, and observes ``framework_extension_point_duration`` once;
the bind tail's points over a batch's items open one ``framework.<point>``
span (``profile``, ``batch``) and observe once, as the JAX commit plane's
batched executors do, with per-pod spans where the JAX package runs the
per-pod executors (the sequential path, a pod Permit allowed: ``per_pod``).
The per-plugin ``plugin_execution_duration`` is sampled as in the JAX
scheduler: the state of one attempt in ``PLUGIN_METRICS_SAMPLE_PERIOD``
(every first attempt) records it (``PreFilterState.sampled``, or the
``sampled`` flags of a batch's items). With tracing off a span costs one
read of the tracer global; the Filter point, the per-node hot loop, has
no span nor histogram of its own unless tracing is on or the attempt is
sampled (the scheduler observes the Filter point once per attempt).
"""

from __future__ import annotations

import contextlib
import dataclasses
from time import perf_counter
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..api.types import ContainerPort, PersistentVolumeClaim, Pod
from ..utils import tracing
from .interface import POINT_METHODS, SKIP, Fail
from .plugins import dynamicresources, interpodaffinity, names, podtopologyspread, volume
from .plugins.dynamicresources import ERR_REASON_PREFILTER_RESTRICTION
from .types import MAX_NODE_SCORE, MIN_NODE_SCORE, WILDCARD_EVENT, ClusterEvent, NodeInfo

DEFAULT_SCHEDULER_NAME = "default-scheduler"
# the host gates, in the loop's order: judged per tenant and per gang, not
# per node
HOST_GATES_ORDER = (names.QUOTA_ADMISSION, names.COSCHEDULING)
HOST_GATES = frozenset(HOST_GATES_ORDER)
# the in-tree Reserve plugins with nothing to do for a pod whose PreFilters
# did not run (a plain winner of a batch, whose state is None): VolumeBinding
# and DynamicResources act on the state's volumes and claims, Coscheduling
# never acts at Reserve. ``reserve_batch`` skips them for such a pod, but for
# a sampled one: JAX calls them on an empty CycleState and times them.
RESERVE_NEEDS_STATE = frozenset((names.VOLUME_BINDING, names.DYNAMIC_RESOURCES,
                                 names.COSCHEDULING))
# a bind-tail item: (the pod's PreFilter state or None, the pod, its node)
BindTriple = Tuple[Optional["PreFilterState"], Pod, str]
# one attempt in this many records the per-plugin durations (the JAX
# scheduler's PLUGIN_METRICS_SAMPLE_PERIOD); attempt 1 always does
PLUGIN_METRICS_SAMPLE_PERIOD = 20
_NULL_CM = contextlib.nullcontext()
# Permit's verdict for a pod parked at WAIT
WAITING = "waiting"


def sampled_attempt(attempts: int) -> bool:
    """Whether the attempt counted ``attempts``-th records the per-plugin
    durations (``scheduler.py:_new_cycle_state``)."""
    return (attempts - 1) % PLUGIN_METRICS_SAMPLE_PERIOD == 0


def status_label(out) -> str:
    """The extension-point status label of a plugin's or a point's result:
    None (or ``SKIP``) succeeds, a ``Fail`` is unschedulable (and
    unresolvable), Permit's ``WAITING`` waits, any other refusal is
    unschedulable."""
    if out is None or out is SKIP:
        return "Success"
    if out is WAITING:
        return "Wait"
    if isinstance(out, Fail):
        return "UnschedulableAndUnresolvable" if out.unresolvable else "Unschedulable"
    return "Unschedulable"


def timed(tr, metrics, point: str, plugin, call, status_of=status_label):
    """One plugin call with its ``plugin.<name>`` span (tracing on) and its
    sampled ``plugin_execution_duration`` (``metrics`` given)."""
    if tr is None and metrics is None:
        return call()
    t0 = perf_counter()
    status = "Error"  # unless call() returns
    try:
        if tr is not None:
            with tr.span("plugin." + plugin.name(), extension_point=point):
                out = call()
        else:
            out = call()
        status = status_of(out)
        return out
    finally:
        if metrics is not None:
            metrics.plugin_execution_duration.observe(perf_counter() - t0, plugin.name(),
                                                      point, status)


def _reserve(plugin, state, pod, node_name):
    return plugin.reserve(state, pod, node_name)


def _pre_bind(plugin, state, pod, node_name):
    return plugin.pre_bind(state, pod, node_name)


def _worst(outs) -> str:
    """A batch's point label: the last failing item's, else Success."""
    label = "Success"
    for out in outs or ():
        if out is not None:
            label = status_label(out)
    return label


def _first_label(out) -> str:
    return status_label(out[1] if out[0] is None else None)


def _success(_out) -> str:
    return "Success"


def _second_label(out) -> str:
    return status_label(out[1])


def _third_label(out) -> str:
    return status_label(out[2])


@contextlib.contextmanager
def point_span(tr, metrics, point: str, profile: str, status_of=status_label, **attrs):
    """The ``framework.<point>`` span (tracing on) and one
    ``framework_extension_point_duration`` observation (``metrics`` given)
    around one run of a point; the body sets ``box[0]`` to its result,
    whose label ``status_of`` gives."""
    box = [None]
    if tr is None and metrics is None:
        yield box
        return
    t0 = perf_counter()
    status = "Error"
    try:
        with (tr.span("framework." + point, profile=profile, **attrs) if tr is not None
              else _NULL_CM):
            yield box
        status = status_of(box[0])
    finally:
        if metrics is not None:
            metrics.framework_extension_point_duration.observe(perf_counter() - t0, point,
                                                               status, profile)


class PodNominator:
    """Tracks preemption nominations (framework/interface.go:690):
    nominated pods are taken into account by the filters of other pods
    before their victims are gone."""

    def __init__(self):
        self._by_node: Dict[str, List[Pod]] = {}
        self._node_of: Dict[str, str] = {}

    def add_nominated_pod(self, pod: Pod, node_name: str) -> None:
        self.delete_nominated_pod_if_exists(pod)
        if node_name:
            self._by_node.setdefault(node_name, []).append(pod)
            self._node_of[pod.key()] = node_name

    def delete_nominated_pod_if_exists(self, pod: Pod) -> None:
        node = self._node_of.pop(pod.key(), None)
        if node is not None:
            self._by_node[node] = [p for p in self._by_node[node] if p.key() != pod.key()]

    def nominated_pods_for_node(self, node_name: str) -> List[Pod]:
        return self._by_node.get(node_name, [])


@dataclasses.dataclass
class PreFilterState:
    """The cycle state of one pod: what its PreFilters (and PreScores)
    computed. NodeAffinity's node-name restriction is returned apart
    (``pre_filter_status``). ``clone`` copies the two count states the
    extensions move, the delayed claims' per-node choice and ``data``; the
    rest is read-only, but for ``allocated``, the claim keys
    DynamicResources' Reserve took. ``data`` holds the PreScore results and
    any other plugin's state, under the plugin's name."""

    ports: Tuple[ContainerPort, ...] = ()                                # NodePorts
    request: Dict[str, int] = dataclasses.field(default_factory=dict)   # NodeResourcesFit
    rwop: Set[str] = dataclasses.field(default_factory=set)             # VolumeRestrictions
    bound: List[PersistentVolumeClaim] = dataclasses.field(default_factory=list)  # VolumeBinding
    spread: podtopologyspread.PreFilterState = dataclasses.field(
        default_factory=podtopologyspread.PreFilterState)
    affinity: interpodaffinity.PreFilterState = dataclasses.field(
        default_factory=interpodaffinity.PreFilterState)
    claims: dynamicresources.Claims = dataclasses.field(default_factory=list)  # DynamicResources
    slice_target: Optional[str] = None      # SlicePacking: the member's planned node
    # VolumeBinding: the delayed (WaitForFirstConsumer) claims, and the
    # PVs the Filter chose for them per node
    delayed: List[PersistentVolumeClaim] = dataclasses.field(default_factory=list)
    node_bindings: Dict[str, List[volume.Binding]] = dataclasses.field(default_factory=dict)
    allocated: List[str] = dataclasses.field(default_factory=list)
    data: Dict[str, object] = dataclasses.field(default_factory=dict)
    sampled: bool = False  # this attempt records the per-plugin durations

    def clone(self) -> "PreFilterState":
        return dataclasses.replace(self, spread=self.spread.clone(),
                                   affinity=self.affinity.clone(),
                                   node_bindings=dict(self.node_bindings), data=dict(self.data))


Points = Dict[str, List[Tuple[object, int]]]


def build_plugins(handle: dict, config: Dict[str, List[Tuple[str, int]]], args: Dict[str, dict],
                  registry: dict) -> Tuple[Dict[str, object], Points]:
    """(plugin name -> instance, point -> [(instance, weight)]) of one
    profile (``runtime.py:161-175``)."""
    instances: Dict[str, object] = {}
    points: Points = {}
    for point, entries in config.items():
        lst = []
        for name, weight in entries:
            factory = registry.get(name)
            if factory is None:
                continue  # a name the registry does not know
            if name not in instances:
                instances[name] = factory(handle, args.get(name, {}))
            method = POINT_METHODS.get(point)
            if method and not hasattr(instances[name], method):
                continue  # a MultiPoint entry at a point its plugin does not implement
            lst.append((instances[name], weight))
        points[point] = lst
    return instances, points


def _named(fail: Fail, plugin) -> Fail:
    return fail if fail.plugin else fail._replace(plugin=plugin.name())


class FilterRunner:
    """A profile's PreFilters and Filters over (pod, NodeInfo), built by
    its ``Framework``. ``node_infos_fn`` lists the cluster's NodeInfos
    (the preemption dry run walks them); ``pre_filters`` and ``filters``
    are the profile's ordered [(plugin, weight)]."""

    def __init__(self, node_infos_fn: Callable[[], Iterable[NodeInfo]], nominator: PodNominator,
                 pre_filters: List[Tuple[object, int]], filters: List[Tuple[object, int]],
                 profile_name: str = DEFAULT_SCHEDULER_NAME, metrics=None):
        self.node_infos_fn = node_infos_fn
        self.nominator = nominator
        self.profile_name = profile_name
        self.metrics = metrics
        self.pre_filters = [p for p, _w in pre_filters]
        self.node_pre_filters = [p for p in self.pre_filters if p.name() not in HOST_GATES]
        self.filters = [p for p, _w in filters]
        self.extensions = [p for p in self.pre_filters if hasattr(p, "add_pod")]
        # set by ``Framework.post_filter`` for the PostFilter point of a
        # sampled attempt: the PreFilters a PostFilter plugin runs through
        # ``pre_filter`` (a batch pod's, whose PreFilters did not run) then
        # record their durations, as the JAX plugin's run on the attempt's
        # sampled CycleState does (C31)
        self.attempt_sampled = False

    def pre_filter(self, pod: Pod) -> Tuple[Optional[PreFilterState], Optional[str]]:
        """(the state, None), or (None, the first failure's reason); sampled
        when the attempt is (``attempt_sampled``)."""
        state, _names, fail = self.pre_filter_status(pod, sampled=self.attempt_sampled)
        return state, (fail.reason if fail is not None else None)

    def pre_filter_status(self, pod: Pod, gates: bool = True, sampled: bool = False
                          ) -> Tuple[Optional[PreFilterState], Optional[Set[str]], Optional[Fail]]:
        """The PreFilters in the profile's order: (the state, the node names
        they restrict the pod to or None for every node, None), or (None,
        None, the first failure). ``gates=False`` leaves out the host
        gates; ``sampled`` marks the attempt whose per-plugin durations are
        recorded."""
        tr = tracing._tracer
        if tr is None and self.metrics is None:
            return self._pre_filter(pod, gates, sampled, None)
        with point_span(tr, self.metrics, "pre_filter", self.profile_name,
                        status_of=_third_label) as box:
            box[0] = self._pre_filter(pod, gates, sampled, tr)
        return box[0]

    def _pre_filter(self, pod: Pod, gates: bool, sampled: bool, tr):
        state = PreFilterState(sampled=sampled)
        metrics = self.metrics if sampled else None
        node_names: Optional[Set[str]] = None
        for plugin in (self.pre_filters if gates else self.node_pre_filters):
            if tr is None and metrics is None:
                restrict, fail = plugin.pre_filter(state, pod)
            else:
                restrict, fail = timed(tr, metrics, "pre_filter", plugin,
                                       lambda p=plugin: p.pre_filter(state, pod),
                                       status_of=_second_label)
            if fail is not None:
                return None, None, _named(fail, plugin)
            if restrict is not None:
                node_names = set(restrict) if node_names is None else node_names & restrict
                if not node_names:
                    return None, None, Fail(plugin.name(), ERR_REASON_PREFILTER_RESTRICTION, True)
        return state, node_names, None

    def filter(self, state: PreFilterState, pod: Pod, ni: NodeInfo) -> Optional[str]:
        """The first failing Filter's reason, or None."""
        fail = self.filter_status(state, pod, ni)
        return fail.reason if fail is not None else None

    def filter_status(self, state: PreFilterState, pod: Pod, ni: NodeInfo) -> Optional[Fail]:
        """The Filters in the profile's order; the first failure, or None.
        Spans (tracing on) and per-plugin durations (a sampled attempt)
        only: the Filter point's duration is observed once per attempt by
        the scheduler, as the reference does."""
        tr = tracing._tracer
        metrics = self.metrics if state is not None and state.sampled else None
        if tr is None and metrics is None:
            for plugin in self.filters:
                fail = plugin.filter(state, pod, ni)
                if fail is not None:
                    return _named(fail, plugin)
            return None
        with (tr.span("framework.filter", profile=self.profile_name) if tr is not None
              else _NULL_CM):
            for plugin in self.filters:
                fail = timed(tr, metrics, "filter", plugin,
                             lambda p=plugin: p.filter(state, pod, ni))
                if fail is not None:
                    return _named(fail, plugin)
        return None

    def add_pod(self, state: PreFilterState, pod: Pod, added: Pod, ni: NodeInfo) -> None:
        """The AddPod extensions: ``added`` joins ``ni`` in the dry run."""
        for plugin in self.extensions:
            plugin.add_pod(state, pod, added, ni)

    def remove_pod(self, state: PreFilterState, pod: Pod, removed: Pod, ni: NodeInfo) -> None:
        """The RemovePod extensions: ``removed`` leaves ``ni``."""
        for plugin in self.extensions:
            plugin.remove_pod(state, pod, removed, ni)

    def filter_with_nominated_pods(self, state: PreFilterState, pod: Pod,
                                   ni: NodeInfo) -> Optional[str]:
        fail = self.filter_with_nominated_pods_status(state, pod, ni)
        return fail.reason if fail is not None else None

    def filter_with_nominated_pods_status(self, state: PreFilterState, pod: Pod,
                                          ni: NodeInfo) -> Optional[Fail]:
        """Two passes (framework.go:791): first with the pods nominated to
        the node at the pod's priority or above added to a copy of the
        NodeInfo and of the state (the AddPod extensions run for each),
        then without; both must pass."""
        name = ni.node.meta.name if ni.node else ""
        nominated = [p for p in self.nominator.nominated_pods_for_node(name)
                     if p.spec.priority >= pod.spec.priority and p.key() != pod.key()]
        if nominated:
            state2 = state.clone()
            ni2 = ni.clone()
            for p in nominated:
                ni2.add_pod(p)
                self.add_pod(state2, pod, p, ni2)
            fail = self.filter_status(state2, pod, ni2)
            if fail is not None:
                return fail
        return self.filter_status(state, pod, ni)


class ScoreRunner:
    """A profile's PreScore and Score points over a pod's feasible nodes
    (``run_pre_score_plugins`` and ``run_score_plugins``): node name ->
    the weighted sum of the normalized scores. ``pre_scores`` and
    ``scores`` are the profile's [(plugin, weight)]."""

    def __init__(self, pre_scores: List[Tuple[object, int]], scores: List[Tuple[object, int]],
                 profile_name: str = DEFAULT_SCHEDULER_NAME, metrics=None):
        self.pre_scores = [p for p, _w in pre_scores]
        self.scores = [(p, w, getattr(p, "normalize_score", None)) for p, w in scores]
        self.profile_name = profile_name
        self.metrics = metrics

    def score(self, pod: Pod, feasible: List[NodeInfo],
              state: Optional[PreFilterState] = None) -> Dict[str, int]:
        if state is None:
            state = PreFilterState()
        tr = tracing._tracer
        sampled = self.metrics if state.sampled else None
        with point_span(tr, self.metrics, "pre_score", self.profile_name):
            for plugin in self.pre_scores:
                timed(tr, sampled, "pre_score", plugin,
                      lambda p=plugin: p.pre_score(state, pod, feasible))
        totals = {ni.node.meta.name: 0 for ni in feasible}
        with point_span(tr, self.metrics, "score", self.profile_name):
            for plugin, weight, normalize in self.scores:
                scores = timed(tr, sampled, "score", plugin,
                               lambda p=plugin, norm=normalize: self._score_one(p, norm, state,
                                                                                pod, feasible),
                               status_of=_success)
                for name, v in scores.items():
                    if not MIN_NODE_SCORE <= v <= MAX_NODE_SCORE:
                        raise RuntimeError(f"plugin {plugin.name()} returned out-of-range "
                                           f"score {v}")
                    totals[name] += v * weight
        return totals

    @staticmethod
    def _score_one(plugin, normalize, state: PreFilterState, pod: Pod,
                   feasible: List[NodeInfo]) -> Dict[str, int]:
        scores = {ni.node.meta.name: plugin.score_node(state, pod, ni) for ni in feasible}
        if normalize is not None:
            normalize(state, pod, scores)
        return scores


class Framework:
    """One profile's plugins (profile/profile.go maps a scheduler name to
    one), built from ``(handle, plugin_config, plugin_args, registry,
    profile_name)``; ``plugin_config`` None is the default set. ``handle``
    is the dict of the scheduler's services the factories read
    (``framework/registry.py``); each profile has its own nominator, as in
    the JAX package."""

    def __init__(self, handle: dict,
                 plugin_config: Optional[Dict[str, List[Tuple[str, int]]]] = None,
                 plugin_args: Optional[Dict[str, dict]] = None, registry=None,
                 profile_name: str = DEFAULT_SCHEDULER_NAME):
        from .registry import DEFAULT_PLUGINS, in_tree_registry

        self.profile_name = profile_name
        self.nominator: PodNominator = handle.setdefault("nominator", PodNominator())
        self._instances, self.points = build_plugins(
            handle, plugin_config or DEFAULT_PLUGINS, plugin_args or {},
            registry or in_tree_registry())
        snapshot_fn = handle.get("snapshot_fn") or (lambda: ())
        self._metrics = handle.get("metrics")
        self.filters = FilterRunner(snapshot_fn, self.nominator, self.points.get("pre_filter", []),
                                    self.points.get("filter", []), profile_name, self._metrics)
        self.scores = ScoreRunner(self.points.get("pre_score", []), self.points.get("score", []),
                                  profile_name, self._metrics)
        for plugin in self._instances.values():
            if hasattr(plugin, "set_framework"):
                plugin.set_framework(self)
        bind = self.points.get("bind", [])
        self.default_binder = (len(bind) == 1 and bind[0][0].name() == names.DEFAULT_BINDER)
        # the host gates the loop runs at pop: (name, plugin) of those present
        self.gate_plugins = tuple((n, self._instances[n]) for n in HOST_GATES_ORDER
                                  if n in self._instances)
        # the bind tail's plugin lists, resolved once
        self._reserve = [p for p, _w in self.points.get("reserve", [])]
        self._reserve_stateless = [p for p in self._reserve
                                   if p.name() not in RESERVE_NEEDS_STATE]
        self._permit = [p for p, _w in self.points.get("permit", [])]
        self._pre_bind = [p for p, _w in self.points.get("pre_bind", [])]
        self._post_bind = [(p, getattr(p, "post_bind_batch", None))
                           for p, _w in self.points.get("post_bind", [])]
        self._pre_enqueue = [p for p, _w in self.points.get("pre_enqueue", [])]

    def plugin(self, name: str):
        return self._instances.get(name)

    def point_names(self, point: str) -> List[Tuple[str, int]]:
        return [(p.name(), w) for p, w in self.points.get(point, [])]

    def cluster_event_map(self) -> Dict[ClusterEvent, Set[str]]:
        """Event -> the plugins that registered it (fillEventToPluginMap);
        a plugin that registers nothing is moved by any event."""
        out: Dict[ClusterEvent, Set[str]] = {}
        for name, plugin in self._instances.items():
            events = plugin.events_to_register() if hasattr(plugin, "events_to_register") else None
            for ev in events or (WILDCARD_EVENT,):
                out.setdefault(ev, set()).add(name)
        return out

    def queue_sort_key(self):
        """The queue's heap key: the first QueueSort plugin's ``sort_key``,
        else PrioritySort's order; FIFO without a QueueSort plugin."""
        qs = self.points.get("queue_sort") or []
        if qs:
            key = getattr(qs[0][0], "sort_key", None)
            return key if key is not None else (lambda qp: (-qp.pod.spec.priority, qp.timestamp))
        return lambda qp: qp.timestamp

    def pre_enqueue(self, pod: Pod):
        """The PreEnqueue point: None to admit, else the first refusal."""
        for plugin in self._pre_enqueue:
            refusal = plugin.pre_enqueue(pod)
            if refusal is not None:
                return refusal
        return None

    def post_filter(self, pod: Pod, hints=None, unresolvable=(), state=None,
                    sampled: bool = False) -> Tuple[Optional[str], Optional[str]]:
        """The PostFilter point: the first plugin that nominates a node
        wins; (None, the last refusal) when none does. ``state`` is the
        sequential cycle's PreFilter outcome (``FitError.state``; None on
        the batch path), handed to every plugin; a ``sampled`` attempt
        records the per-plugin durations."""
        tr, m = tracing._tracer, self._metrics
        rec = m if sampled else None
        reason = "no PostFilter plugin could resolve"
        self.filters.attempt_sampled = sampled
        try:
            with point_span(tr, m, "post_filter", self.profile_name,
                            status_of=_first_label) as box:
                for plugin, _w in self.points.get("post_filter", []):
                    node, reason = timed(tr, rec, "post_filter", plugin,
                                         lambda p=plugin: p.post_filter(pod, hints,
                                                                        unresolvable, state),
                                         status_of=_first_label)
                    if node:
                        box[0] = (node, None)
                        return box[0]
                box[0] = (None, reason)
        finally:
            self.filters.attempt_sampled = False
        return None, reason

    # the bind tail, over the profile's items of a batch (``runtime.py:
    # 541-606``): item by item in order, each item's plugins in the point's
    # order, the first refusal per item wins. Over a batch one span and one
    # duration cover the point (JAX's batched executors); ``per_pod`` gives
    # each item its own span with its plugins' spans and its own duration
    # (JAX's per-pod executors: the sequential path, a pod Permit allowed).
    # ``sampled`` flags the items whose per-plugin durations are recorded.

    def _run_point(self, point: str, items: List[BindTriple], call, per_pod: bool,
                   sampled: Optional[Sequence[bool]], plugins: list,
                   stateless: Optional[list] = None) -> list:
        """``call(plugin, state, pod, node_name)`` per item over
        ``plugins`` (``stateless`` for an item without PreFilter state that
        is not sampled), the first refusal per item kept (None: every
        plugin passed)."""
        tr, m = tracing._tracer, self._metrics
        if not items or (not per_pod and not plugins):
            return [None] * len(items)
        if stateless is None:
            stateless = plugins
        if per_pod:
            out = []
            for i, (state, pod, node) in enumerate(items):
                rec = m if sampled and sampled[i] else None
                with point_span(tr, m, point, self.profile_name) as box:
                    for plugin in (plugins if state is not None or rec is not None else stateless):
                        box[0] = timed(tr, rec, point, plugin,
                                       lambda p=plugin: call(p, state, pod, node))
                        if box[0] is not None:
                            break
                out.append(box[0])
            return out
        with point_span(tr, m, point, self.profile_name, status_of=_worst,
                        batch=len(items)) as box:
            out = box[0] = []
            for i, (state, pod, node) in enumerate(items):
                rec = m if sampled and sampled[i] else None
                reason = None
                for plugin in (plugins if state is not None or rec is not None else stateless):
                    reason = (call(plugin, state, pod, node) if rec is None
                              else timed(None, rec, point, plugin,
                                         lambda p=plugin: call(p, state, pod, node)))
                    if reason is not None:
                        break
                out.append(reason)
        return out

    def reserve_batch(self, items: List[BindTriple], per_pod: bool = False,
                      sampled: Optional[Sequence[bool]] = None) -> List[Optional[str]]:
        """The Reserve point per item: the first refusal, or None. An item
        without PreFilter state skips ``RESERVE_NEEDS_STATE`` unless it is
        sampled."""
        return self._run_point("reserve", items, _reserve, per_pod, sampled, self._reserve,
                               self._reserve_stateless)

    def unreserve(self, state: Optional[PreFilterState], pod: Pod, node_name: str) -> None:
        """Unreserve, the Reserve plugins in reverse (per pod, as JAX's
        ``run_reserve_plugins_unreserve``)."""
        tr, m = tracing._tracer, self._metrics
        if tr is None and m is None:
            for plugin in reversed(self._reserve):
                plugin.unreserve(state, pod, node_name)
            return
        rec = m if state is not None and state.sampled else None
        with point_span(tr, m, "unreserve", self.profile_name):
            for plugin in reversed(self._reserve):
                timed(tr, rec, "unreserve", plugin,
                      lambda p=plugin: p.unreserve(state, pod, node_name))

    def permit_batch(self, items: List[BindTriple], on_wait: Callable[[int, float], None],
                     per_pod: bool = False,
                     sampled: Optional[Sequence[bool]] = None) -> List[Optional[str]]:
        """The Permit point per item: the first rejection's reason, or None;
        the first WAIT calls ``on_wait(i, seconds)`` before the next item's
        Permit runs (a gang's quorum counts the member parked) and gives
        ``WAITING``."""
        row = {id(pod): i for i, (_st, pod, _node) in enumerate(items)}

        def permit(plugin, state, pod, node):
            reason, wait_s = plugin.permit(state, pod, node)
            if reason is None and wait_s is not None:
                on_wait(row[id(pod)], wait_s)
                return WAITING
            return reason

        return self._run_point("permit", items, permit, per_pod, sampled, self._permit)

    def pre_bind_batch(self, items: List[BindTriple], per_pod: bool = False,
                       sampled: Optional[Sequence[bool]] = None) -> List[Optional[str]]:
        """The PreBind point per item: the first refusal, or None."""
        return self._run_point("pre_bind", items, _pre_bind, per_pod, sampled, self._pre_bind)

    def bind(self, state: Optional[PreFilterState], pod: Pod, node_name: str) -> Optional[str]:
        """The Bind point, one pod: the first outcome that is not ``SKIP``."""
        tr, m = tracing._tracer, self._metrics
        rec = m if state is not None and state.sampled else None
        with point_span(tr, m, "bind", self.profile_name) as box:
            box[0] = "no bind plugin accepted the pod"
            for plugin, _w in self.points.get("bind", []):
                out = (plugin.bind(state, pod, node_name) if tr is None and rec is None
                       else timed(tr, rec, "bind", plugin,
                                  lambda p=plugin: p.bind(state, pod, node_name)))
                if out is not SKIP:
                    box[0] = out
                    break
        return box[0]

    def default_bind(self, call: Callable[[], Optional[str]], sampled: bool = False
                     ) -> Optional[str]:
        """One pod bound by ``call`` (the store's bind) on behalf of the
        DefaultBinder, instrumented as the per-pod Bind point."""
        tr, m = tracing._tracer, self._metrics
        if tr is None and m is None:
            return call()
        plugin = self.points["bind"][0][0]
        with point_span(tr, m, "bind", self.profile_name) as box:
            box[0] = timed(tr, m if sampled else None, "bind", plugin, call)
        return box[0]

    def observe_batched_bind(self, seconds: float, failed: int, sampled: bool) -> None:
        """The store's one bind pass over a batch's DefaultBinder pods: one
        Bind-point duration, and the DefaultBinder's when an item is
        sampled (``commit_plane.py:345-358``)."""
        m = self._metrics
        if m is None:
            return
        status = "Success" if failed == 0 else "Error"
        m.framework_extension_point_duration.observe(seconds, "bind", status, self.profile_name)
        if sampled:
            for plugin, _w in self.points.get("bind", []):
                m.plugin_execution_duration.observe(seconds, plugin.name(), "bind", status)

    def post_bind_batch(self, pods: List[Pod], per_pod: bool = False,
                        sampled: Optional[Sequence[bool]] = None) -> None:
        """The PostBind point over a batch's bound pods, each plugin over
        the batch in turn (one call when it has ``post_bind_batch``);
        ``per_pod`` runs it pod by pod, a span each."""
        tr, m = tracing._tracer, self._metrics
        if not self._post_bind or not pods:
            return
        if per_pod:
            for i, pod in enumerate(pods):
                rec = m if sampled and sampled[i] else None
                with point_span(tr, m, "post_bind", self.profile_name):
                    for plugin, batch_fn in self._post_bind:
                        timed(tr, rec, "post_bind", plugin,
                              lambda p=plugin, fn=batch_fn: self._post_bind_one(p, fn, [pod]),
                              status_of=_success)
            return
        rec = m if sampled and any(sampled) else None
        with point_span(tr, m, "post_bind", self.profile_name, batch=len(pods)):
            for plugin, batch_fn in self._post_bind:
                timed(None, rec, "post_bind", plugin,
                      lambda p=plugin, fn=batch_fn: self._post_bind_one(p, fn, pods),
                      status_of=_success)

    @staticmethod
    def _post_bind_one(plugin, batch_fn, pods: List[Pod]) -> None:
        if batch_fn is not None:
            batch_fn(pods)
        else:
            for pod in pods:
                plugin.post_bind(None, pod, pod.spec.node_name)
