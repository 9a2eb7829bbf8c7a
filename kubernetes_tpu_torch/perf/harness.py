"""scheduler_perf: the declarative throughput and latency harness (an own
copy of ``kubernetes_tpu/perf/harness.py`` over the port's scheduler).

Analog of test/integration/scheduler_perf: test cases as op lists
(``perf/cases.py``), the ops createNodes / createPods / measurePods /
churn / barrier / sleep (scheduler_perf_test.go:253-518) and the phases the
JAX harness adds (soak, borrow, replay, elastic, slice stats; the round
loops of the first four are ``perf/phases.py``'s, which
``perf/workloads.py``'s ``*_rounds`` drive too), a throughputCollector
sampling scheduled-pod deltas at 1 s granularity (util.go:284-329), a
metricsCollector over the registry's histograms
(util.go:204-238), and DataItems JSON with the same schema
(util.go:331-351), under the JAX op names, DataItem names and labels.

Backends, under the JAX names: ``oracle`` (the sequential path: the
port's loop built from the config by ``scheduler_from_config``, driven only
through ``schedule_one``, whose bind tail the loop holds; the port's
``scheduler/scheduler.py:Scheduler`` is its abstract base), ``tpu``
(``backend/tpu_scheduler.py:TPUScheduler``, whose mode-``off`` batches run
the fused CUDA kernel), ``wire`` and ``grpc`` (``WireScheduler`` against a
``DeviceService`` behind a localhost HTTP or gRPC socket). ``device`` is
where the batched backends (and the rebalancer's score) run: None is the
card, and raises without one; the tests pass ``"cpu"``.

Differences from the JAX harness: the port's histograms give exact
percentiles (``metrics/registry.py``), so the latency DataItems are exact
quantiles of the phase's observations, not bucket estimates (but
ReplayInvariants' TenantP99Max, the JAX registry's estimate); on the
``oracle`` backend the loop's batch machinery stays out, as the JAX
sequential scheduler has none: no warm sweep, no device flap, no relay
breaker, no device mirror, and the replay's rebalancer is driven by the
harness alone (not from the loop's housekeeping); the soak's
scripted device flap raises a ``TransientDeviceError`` (the port's loop
counts only those on its relay breaker and raises any other); the
elastic phase reads the loop's ``DeviceState`` from ``sched.state``; the
schedulers take no ``seed`` (their tie-breaks hash the pod's key).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..api.wrappers import make_node, make_pod
from ..apiserver.store import Store
from ..config import load_config, scheduler_from_config
from ..utils.device import DeviceLike


@dataclass
class DataItem:
    """util.go:55 DataItem."""

    data: Dict[str, float]
    unit: str
    labels: Dict[str, str] = field(default_factory=dict)


def data_items_to_json(items: List[DataItem], version: str = "v1") -> str:
    """util.go:165 dataItems2JSONFile schema."""
    return json.dumps(
        {
            "version": version,
            "dataItems": [
                {"data": it.data, "unit": it.unit, "labels": it.labels} for it in items
            ],
        },
        indent=2,
    )


# the default scrape set of the metricsCollector below: per-phase latency
# attribution (extension points + plugins + batch phases + algorithm time)
# riding along with every measured workload, scheduler_perf-style
DEFAULT_COLLECTED_METRICS = (
    "scheduler_framework_extension_point_duration_seconds",
    "scheduler_plugin_execution_duration_seconds",
    "scheduler_scheduling_algorithm_duration_seconds",
    "scheduler_tpu_batch_duration_seconds",
)


class MetricsCollector:
    """scheduler_perf's metricsCollector (util.go:204-238): scrape-delta
    percentiles over a configurable histogram list, looked up by family
    name in ``registry``. ``start()`` marks every labelset before the
    measured phase; ``collect()`` emits one DataItem per (metric, labelset)
    that saw samples during the phase (exact quantiles of those samples),
    labelsets first observed mid-phase counted from zero."""

    def __init__(self, registry, metric_names=DEFAULT_COLLECTED_METRICS):
        self.registry = registry
        self.names = list(metric_names)
        self._snaps: Dict[tuple, int] = {}

    def _histograms(self):
        for name in self.names:
            h = self.registry.get(name)
            if h is not None and hasattr(h, "percentile_since"):
                yield name, h

    def start(self) -> None:
        self._snaps.clear()
        for name, h in self._histograms():
            for lv in h.label_sets():
                self._snaps[(name, lv)] = h.snapshot(*lv)

    def collect(self) -> List["DataItem"]:
        items: List[DataItem] = []
        for name, h in self._histograms():
            short = name[len("scheduler_"):] if name.startswith("scheduler_") else name
            unit = "s" if name.endswith("_seconds") else ""
            for lv in h.label_sets():
                snap = self._snaps.get((name, lv), 0)
                n = h.count_since(snap, *lv)
                if n == 0:
                    continue
                items.append(DataItem(
                    data={
                        "Perc50": h.percentile_since(snap, 0.50, *lv),
                        "Perc90": h.percentile_since(snap, 0.90, *lv),
                        "Perc99": h.percentile_since(snap, 0.99, *lv),
                        "Count": float(n),
                    },
                    unit=unit,
                    labels={"Name": short, **dict(zip(h.label_names, lv))},
                ))
        return items


class ThroughputCollector:
    """util.go:284: samples scheduled-pod count each interval; pods/s series."""

    def __init__(self, count_fn: Callable[[], int], interval: float = 1.0):
        self.count_fn = count_fn
        self.interval = interval
        self.samples: List[float] = []
        self._last_count = 0
        self._last_t: Optional[float] = None
        self._first: Optional[tuple] = None  # (count, t) at the start
        self._end: Optional[tuple] = None  # (count, t) at finish

    def start(self, now: float) -> None:
        self._last_count = self.count_fn()
        self._last_t = now
        if self._first is None:
            self._first = (self._last_count, now)

    def maybe_sample(self, now: float) -> None:
        if self._last_t is None:
            self.start(now)
            return
        if now - self._last_t >= self.interval:
            count = self.count_fn()
            self.samples.append((count - self._last_count) / (now - self._last_t))
            self._last_count = count
            self._last_t = now

    def finish(self, now: float) -> None:
        self._end = (self.count_fn(), now)
        if self._last_t is not None and now > self._last_t:
            count = self._end[0]
            if count != self._last_count:
                self.samples.append((count - self._last_count) / (now - self._last_t))

    def window(self) -> tuple:
        """(pods, seconds) from the start to ``finish``: the whole
        window's rate is their ratio. ``summary``'s Average is the mean of
        the samples' rates, as util.go's is, which weighs a short last
        sample as much as a full interval."""
        if self._first is None or self._end is None:
            return 0, 0.0
        count0, t0 = self._first
        return self._end[0] - count0, self._end[1] - t0

    def summary(self) -> Dict[str, float]:
        """SchedulingThroughput Average/Perc50/90/95/99 (util.go:331)."""
        if not self.samples:
            return {"Average": 0.0, "Perc50": 0.0, "Perc90": 0.0, "Perc95": 0.0, "Perc99": 0.0}
        s = sorted(self.samples)

        def pct(q: float) -> float:
            i = min(len(s) - 1, max(0, int(q * len(s)) - 1))
            return s[i]

        return {
            "Average": sum(s) / len(s),
            "Perc50": pct(0.50),
            "Perc90": pct(0.90),
            "Perc95": pct(0.95),
            "Perc99": pct(0.99),
        }


# ---------------------------------------------------------------------------
# workload ops


def _node_wrapper(i: int, params: dict):
    nw = make_node(f"node-{i}").capacity(
        params.get("capacity", {"cpu": "32", "memory": "128Gi", "pods": 110})
    )
    for k, v in (params.get("labels") or {}).items():
        nw.label(k, str(v).format(i=i, zone=i % params.get("zones", 10)))
    if params.get("zones"):
        nw.label("topology.kubernetes.io/zone", f"zone-{i % params['zones']}")
        nw.label("kubernetes.io/hostname", f"node-{i}")
    if params.get("device_attributes"):
        # node-published device slice (resource.k8s.io): list values vary
        # per node (value[i % len]) so workloads can shape the feasible set
        attrs = {}
        for k, v in dict(params["device_attributes"]).items():
            attrs[k] = v[i % len(v)] if isinstance(v, (list, tuple)) else v
        nw.device_attrs(attrs)
    if params.get("tpu_topology"):
        # well-known torus coordinate labels (ops/encode.py): node i is
        # host (i // slots, i % slots) — slot order is the superpod's
        # linearized torus walk, so consecutive ordinals are torus-adjacent
        from ..ops.slice import TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL

        slots = int(dict(params["tpu_topology"]).get("slots", 16))
        nw.label(TOPO_SUPERPOD_LABEL, str(i // slots))
        nw.label(TOPO_SLOT_LABEL, str(i % slots))
    return nw


def _pod_wrapper(i: int, prefix: str, params: dict):
    pw = make_pod(f"{prefix}-{i}",
                  namespace=str(params.get("namespace", "default")))
    pw.req(params.get("req", {"cpu": "900m", "memory": "2Gi"}))
    if params.get("gang_size"):
        # gang membership: consecutive pods share one PodGroup (the Runner
        # creates it with minMember = gang size), and each member carries a
        # required anti-affinity to its OWN group on the hostname key — the
        # multi-host TPU contract, one worker per host
        from ..api.types import LabelSelector, POD_GROUP_LABEL

        size = int(params["gang_size"])
        # group by the op-LOCAL ordinal: the global pod counter does not
        # start at a multiple of the gang size, and a gang split across a
        # misaligned boundary could never reach quorum
        group = f"{prefix}-pg{int(params.get('_gang_ordinal', i)) // size}"
        pw.pod_group(group)
        if params.get("slice"):
            # slice gang: contiguous-torus placement contract (ops/slice.py)
            # instead of the flat gang assigner; the planner pins one member
            # per host, so the anti-affinity term is usually redundant here
            from ..ops.slice import SLICE_LABEL

            pw.label(SLICE_LABEL, "1")
        if params.get("gang_anti_affinity", True):
            pw.pod_affinity(
                "kubernetes.io/hostname",
                LabelSelector(match_labels={POD_GROUP_LABEL: group}),
                anti=True)
    if params.get("node_affinity_in"):
        # pod-with-node-affinity.yaml: required NodeAffinity In terms
        for key, values in dict(params["node_affinity_in"]).items():
            pw.node_affinity_in(key, list(values))
    if params.get("ns_selector_anti_affinity"):
        # pod-anti-affinity-ns-selector.yaml: required anti-affinity whose
        # term matches the pod's own label across namespaces selected by a
        # namespaceSelector
        from ..api.types import (Affinity, LabelSelector, PodAffinityTerm,
                                 PodAntiAffinity, WeightedPodAffinityTerm)

        cfg = dict(params["ns_selector_anti_affinity"])
        match = dict(cfg.get("match_labels", {"color": "green"}))
        for k, v in match.items():
            pw.label(k, v)
        term = PodAffinityTerm(
            label_selector=LabelSelector(match_labels=match),
            topology_key=cfg.get("topology_key", "kubernetes.io/hostname"),
            namespace_selector=LabelSelector(
                match_labels=dict(cfg.get("ns_labels", {"team": "devops"}))),
        )
        aff = pw.pod.spec.affinity or Affinity()
        if cfg.get("preferred"):
            paa = PodAntiAffinity(preferred=(
                WeightedPodAffinityTerm(weight=int(cfg.get("weight", 1)),
                                        term=term),))
        else:
            paa = PodAntiAffinity(required=(term,))
        aff.pod_anti_affinity = paa
        pw.pod.spec.affinity = aff
    for k, v in (params.get("labels") or {}).items():
        pw.label(k, str(v).format(i=i))
    if params.get("priority") is not None:
        pw.priority(int(params["priority"]))
    if params.get("pod_affinity_labels"):
        # pod-with-pod-(anti-)affinity.yaml shape: the pod carries the labels
        # its own required (anti-)affinity term selects on.
        from ..api.types import LabelSelector

        match = dict(params["pod_affinity_labels"])
        for k, v in match.items():
            pw.label(k, v)
        pw.pod_affinity(
            params.get("pod_affinity_key", "kubernetes.io/hostname"),
            LabelSelector(match_labels=match),
            anti=bool(params.get("anti")),
        )
    if params.get("preferred_affinity_labels"):
        # pod-with-preferred-pod-(anti-)affinity.yaml shape: a weighted
        # preferred term selecting the pod's own label on hostname
        from ..api.types import LabelSelector

        match = dict(params["preferred_affinity_labels"])
        for k, v in match.items():
            pw.label(k, v)
        pw.preferred_pod_affinity(
            int(params.get("weight", 1)),
            params.get("pod_affinity_key", "kubernetes.io/hostname"),
            LabelSelector(match_labels=match),
            anti=bool(params.get("anti")),
        )
    if params.get("secret_volume"):
        # pod-with-secret-volume.yaml: mounts need no binding and never
        # gate scheduling; the row measures the codec/admission cost only
        pw.pod.spec.secret_volumes = (str(params["secret_volume"]),)
    for claim in params.get("claims") or ():
        # resource.k8s.io claim template reference; the resourceclaim
        # controller (pumped by the Runner) materializes the claim object
        pw.resource_claim(str(claim.get("name", "claim")),
                          template_name=str(claim.get("template", "template")))
    if params.get("spread_topology_key"):
        from ..api.types import (LabelSelector, TopologySpreadConstraint,
                                 DO_NOT_SCHEDULE, SCHEDULE_ANYWAY)

        pw.label("spread-app", prefix)
        when = (SCHEDULE_ANYWAY if params.get("spread_preferred")
                else DO_NOT_SCHEDULE)
        pw.pod.spec.topology_spread_constraints = (
            TopologySpreadConstraint(
                max_skew=int(params.get("max_skew", 1)),
                topology_key=params["spread_topology_key"],
                when_unsatisfiable=when,
                label_selector=LabelSelector(match_labels={"spread-app": prefix}),
            ),
        )
    return pw


class Runner:
    """runWorkload (scheduler_perf_test.go:623)."""

    def __init__(self, scheduler_config: Optional[dict] = None, backend: str = "oracle",
                 batch_size: int = 128,
                 collect_metrics: Optional[List[str]] = None,
                 now_fn: Optional[Callable[[], float]] = None,
                 comparer_every_n: int = 0,
                 ledger: Optional[bool] = None,
                 device: DeviceLike = None):
        self.store = Store()
        self.backend = backend
        # where the batched backends and the rebalancer's score run
        self.device = device
        # injectable clock (soak workloads drive a FakeClock so queue-wait
        # measurement is deterministic in tier-1); None = wall monotonic
        self.now_fn = now_fn or time.monotonic
        # metricsCollector scrape list (None = the default per-phase set;
        # pass an empty list to disable the extra DataItems)
        self.collect_metrics = (DEFAULT_COLLECTED_METRICS
                                if collect_metrics is None else collect_metrics)
        clock_kw = {"now_fn": now_fn} if now_fn is not None else {}
        cfg = load_config(scheduler_config)
        if backend == "tpu":
            from ..backend.tpu_scheduler import TPUScheduler

            self.scheduler = TPUScheduler(self.store, device=device, batch_size=batch_size,
                                          comparer_every_n=comparer_every_n,
                                          **clock_kw)
        elif backend == "wire":
            # transport-inclusive mode: the batched device service behind a
            # real localhost HTTP socket (SURVEY §5.8 hop 6)
            from ..backend.service import DeviceService, WireScheduler, serve

            self._service = DeviceService(batch_size=batch_size, device=device)
            self._server, port = serve(self._service)
            self.scheduler = WireScheduler(
                self.store, endpoint=f"http://127.0.0.1:{port}",
                batch_size=batch_size, **clock_kw)
        elif backend == "grpc":
            # the hardened transport: gRPC framing + template-deduped pod
            # batches (backend/grpc_service.py)
            from ..backend.grpc_service import serve_grpc
            from ..backend.service import DeviceService, WireScheduler

            self._service = DeviceService(batch_size=batch_size, device=device)
            self._server, port = serve_grpc(self._service)
            self._grpc = True
            self.scheduler = WireScheduler(
                self.store, endpoint=f"127.0.0.1:{port}",
                batch_size=batch_size, transport="grpc",
                **clock_kw)
        elif backend == "oracle":
            # the sequential path: the loop holds its bind tail, and only
            # schedule_one drives it here (``_settle``, ``_cycle``)
            self.scheduler = scheduler_from_config(self.store, cfg, device=device,
                                                   **clock_kw)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self._batched = backend != "oracle"
        self.data_items: List[DataItem] = []
        # per measurePods op: its label, the pods scheduled and the wall
        # seconds of its window (ThroughputCollector.window)
        self.measured_windows: List[dict] = []
        self._pod_counter = 0
        self._node_counter = 0
        # pod-lifetime latency ledger (metrics/latency_ledger.py): on for
        # this run when requested (``ledger=True`` or KTPU_LEDGER=1), feeding
        # THIS scheduler's
        # registry on the runner's clock with the quota tenant index
        # bounding the {namespace} SLO label set. Owned enablement only:
        # an externally-managed ledger (a test's) is never hijacked, and
        # ``close()`` restores the disabled default.
        import os as _os

        # resource.k8s.io side-car loop: the resourceclaim controller that
        # materializes template claims, created lazily on the first DRA
        # workload op and pumped by barrier/measure (the reference harness
        # runs the full controller-manager; only this loop gates scheduling)
        self._dra_controller = None
        self._dra_factory = None
        self._own_ledger = False
        if ledger or (ledger is None
                      and _os.environ.get("KTPU_LEDGER") == "1"):
            self._enable_ledger()

    def _enable_ledger(self) -> None:
        from ..metrics import latency_ledger

        if latency_ledger.get() is None:
            latency_ledger.enable(
                self.scheduler.smetrics, now_fn=self.now_fn,
                tenant_fn=getattr(self.scheduler, "_ns_fair_weight", None))
            self._own_ledger = True

    def close(self) -> None:
        """Release backend resources: the scheduler's (the batch ring and
        commit worker; a wire scheduler's client and gRPC channel), then the
        wire backend's server thread and socket (serve()'s contract: the
        caller owns shutdown)."""
        if self._own_ledger:
            from ..metrics import latency_ledger

            latency_ledger.disable()
            self._own_ledger = False
        close = getattr(getattr(self, "scheduler", None), "close", None)
        if close is not None:
            close()
        server = getattr(self, "_server", None)
        if server is not None:
            if getattr(self, "_grpc", False):
                server.stop(0)
            else:
                server.shutdown()
                server.server_close()  # release the listening socket fd
            self._server = None

    # ---- ops ----

    def create_nodes(self, count: int, **params) -> None:
        from ..api.types import CSINode, ObjectMeta

        csi_driver = params.pop("csi_driver", None)
        csi_count = int(params.pop("csi_count", 39))
        # monotonic ordinal, never reused: under elastic churn (nodes
        # deleted mid-run) naming by len(store.nodes) would collide with
        # live names — replacements must be NEW identities (fresh hostname
        # vocab entries, the shrink-then-grow stress the elastic workload
        # exists to exercise)
        created = 0
        while created < count:
            i = self._node_counter
            self._node_counter += 1
            if f"node-{i}" in self.store.nodes:
                continue  # pre-churn ordinal still live
            node = _node_wrapper(i, params).obj()
            self.store.create_node(node)
            created += 1
            if csi_driver:
                # nodeAllocatableStrategy.csiNodeAllocatable
                # (performance-config.yaml:142-148): per-node CSINode with
                # the driver's attachable-volume limit
                self.store.create_csinode(CSINode(
                    meta=ObjectMeta(name=node.meta.name),
                    drivers={csi_driver: csi_count}))

    def _ensure_dra(self, claims, namespace: str) -> None:
        """Create the shared ResourceClass/ResourceClaimTemplate objects a
        claims param references, and start the resourceclaim controller."""
        from ..api.types import ObjectMeta, ResourceClaimTemplate, ResourceClass

        if self._dra_controller is None:
            from ..client.informer import SharedInformerFactory
            from ..controllers.resourceclaim import ResourceClaimController

            self._dra_factory = SharedInformerFactory(self.store)
            self._dra_controller = ResourceClaimController(
                self.store, self._dra_factory)
            self._dra_factory.wait_for_cache_sync()
        for cfg in claims:
            cls_name = str(cfg.get("class", "example.com/device"))
            if self.store.get_object("ResourceClass", cls_name) is None:
                self.store.create_object("ResourceClass", ResourceClass(
                    meta=ObjectMeta(name=cls_name, namespace=""),
                    driver_name=cls_name,
                    selectors=dict(cfg.get("class_selectors") or {})))
            tmpl_name = str(cfg.get("template", "template"))
            if self.store.get_object(
                    "ResourceClaimTemplate", f"{namespace}/{tmpl_name}") is None:
                self.store.create_object(
                    "ResourceClaimTemplate", ResourceClaimTemplate(
                        meta=ObjectMeta(name=tmpl_name, namespace=namespace),
                        resource_class_name=cls_name,
                        selectors=dict(cfg.get("selectors") or {})))

    def _ensure_pod_group(self, pod, params: dict) -> None:
        """Create the PodGroup a gang pod's label references (minMember =
        the gang size unless overridden) — the workload-side contract the
        Coscheduling plugin gates on."""
        from ..api.types import ObjectMeta, POD_GROUP_LABEL, PodGroup

        name = pod.meta.labels.get(POD_GROUP_LABEL)
        if not name:
            return
        key = f"{pod.meta.namespace}/{name}"
        if self.store.get_object("PodGroup", key) is None:
            self.store.create_object("PodGroup", PodGroup(
                meta=ObjectMeta(name=name, namespace=pod.meta.namespace),
                min_member=int(params.get("gang_min_member",
                                          params.get("gang_size", 1))),
                schedule_timeout_seconds=int(
                    params.get("gang_timeout_s", 0))))

    def _pump_dra(self) -> None:
        """One resourceclaim controller round (claims materialize before the
        scheduler's next look at their pods)."""
        if self._dra_controller is not None:
            self._dra_factory.pump()
            self._dra_controller.sync_once()

    def _make_pod(self, prefix: str, params: dict):
        """One pod plus any per-pod side objects (pre-bound PV/PVC pairs,
        the shared Secret) — the persistentVolumeTemplatePath /
        defaultPodTemplatePath machinery of the reference harness."""
        pw = _pod_wrapper(self._pod_counter, prefix, params)
        if params.get("gang_size"):
            self._ensure_pod_group(pw.pod, params)
        if params.get("claims"):
            self._ensure_dra(params["claims"], pw.pod.meta.namespace)
        if params.get("secret_volume"):
            name = str(params["secret_volume"])
            ns = pw.pod.meta.namespace
            if self.store.get_object("Secret", f"{ns}/{name}") is None:
                from ..api.types import ObjectMeta, Secret

                self.store.create_object("Secret", Secret(
                    meta=ObjectMeta(name=name, namespace=ns)))
        pvc_params = params.get("pvc")
        if pvc_params:
            # pv-aws.yaml / pv-csi.yaml + pvc.yaml per measured pod, pre-bound
            # (the reference's StartFakePVController completes the binding;
            # here the pair is created already bound, the same steady state)
            from ..api.types import ObjectMeta, PersistentVolume, PersistentVolumeClaim

            i = self._pod_counter
            ns = pw.pod.meta.namespace
            pv_name, pvc_name = f"pv-{prefix}-{i}", f"pvc-{prefix}-{i}"
            self.store.create_pv(PersistentVolume(
                meta=ObjectMeta(name=pv_name),
                capacity_bytes=1 << 30,
                bound_pvc=f"{ns}/{pvc_name}",
                access_modes=("ReadOnlyMany",),
                volume_type=str(pvc_params.get("volume_type", "")),
            ))
            self.store.create_pvc(PersistentVolumeClaim(
                meta=ObjectMeta(name=pvc_name, namespace=ns,
                                annotations={"pv.kubernetes.io/bind-completed": "true"}),
                bound_pv=pv_name,
                access_modes=("ReadOnlyMany",),
                requested_bytes=1 << 30,
            ))
            pw.pvc(pvc_name)
        return pw.obj()

    def create_pods(self, count: int, prefix: str = "pod", **params) -> None:
        for j in range(count):
            self.store.create_pod(self._make_pod(
                prefix, dict(params, _gang_ordinal=j)
                if params.get("gang_size") else params))
            self._pod_counter += 1
        self._pump_dra()

    def create_namespaces(self, count: int, prefix: str = "ns",
                          labels: Optional[dict] = None) -> None:
        """createNamespaces op (namespace-with-labels.yaml): labeled
        namespaces for namespaceSelector affinity terms."""
        from ..api.types import Namespace, ObjectMeta

        for i in range(count):
            self.store.create_namespace(Namespace(
                meta=ObjectMeta(name=f"{prefix}-{i}", namespace="",
                                labels=dict(labels or {}))))

    def create_quota(self, namespace: str, hard: dict, weight: int = 1,
                     name: str = "quota", cohort: str = "") -> None:
        """createQuota op: the namespace's SchedulingQuota (plus the
        Namespace object itself) — the tenant contract the QuotaAdmission
        plugin and the queue's fair-share layer read. ``cohort`` joins the
        namespace to a borrowing pool."""
        from ..api.types import Namespace, ObjectMeta, SchedulingQuota

        if namespace not in self.store.namespaces:
            self.store.create_namespace(Namespace(
                meta=ObjectMeta(name=namespace, namespace="")))
        self.store.create_object("SchedulingQuota", SchedulingQuota(
            meta=ObjectMeta(name=name, namespace=namespace),
            hard=dict(hard), weight=int(weight), cohort=str(cohort)))

    def barrier(self, timeout_s: float = 300.0) -> None:
        """Wait (drive) until every pending pod has been attempted
        (scheduler_perf_test.go:518 barrierOp)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._pump_dra()
            progressed = self._settle()
            if len(self.scheduler.queue) == 0:
                return
            if not progressed:
                return  # only unschedulable pods remain
        raise TimeoutError("barrier timed out")

    def _settle(self) -> int:
        """The scheduler's settle loop: the batch cycles', or on ``oracle``
        the JAX sequential scheduler's (``scheduler/scheduler.py:922-934``):
        ``schedule_one`` until the active queue stays empty after a backoff
        flush. Returns the cycles run."""
        if self._batched:
            return self.scheduler.run_until_settled()
        cycles = 0
        while cycles < 100000:
            if not self.scheduler.schedule_one():
                self.scheduler.queue.flush_backoff_completed()
                if self.scheduler.queue.pending_pods()["active"] > 0:
                    continue
                break
            cycles += 1
        return cycles

    def _cycle(self) -> bool:
        """One cycle: a batch cycle, or one sequential pod on ``oracle``.
        True when it made progress."""
        if self._batched:
            return self.scheduler.schedule_batch_cycle() > 0
        return self.scheduler.schedule_one()

    def churn(self, count: int = 100, prefix: str = "churn") -> None:
        """churnOp (:442): background create/delete during measurement."""
        for i in range(count):
            p = make_pod(f"{prefix}-{i}").req({"cpu": "1m"}).obj()
            self.store.create_pod(p)
            self.store.delete_pod(p.key())

    # ---- measured phase ----

    def measure(self, count: int, prefix: str = "measured", collector_interval: float = 1.0,
                label: str = "SchedulingThroughput", churn_every: int = 0,
                **params) -> Dict[str, float]:
        def scheduled_count():
            return self.scheduler.metrics["scheduled"]

        # Attempt-latency percentiles over just the measured phase
        # (scrape-delta around the phase, like metricsCollector in util.go).
        from ..config.types import DEFAULT_SCHEDULER_NAME

        hist = self.scheduler.smetrics.scheduling_attempt_duration
        profile = DEFAULT_SCHEDULER_NAME
        lat_snaps = {res: hist.snapshot(res, profile)
                     for res in ("scheduled", "unschedulable")}
        # pod-lifetime e2e + segment attribution over the measured phase
        # (latency ledger; items appear only when the ledger is enabled)
        e2e_hist = self.scheduler.smetrics.pod_e2e_duration
        e2e_snap = e2e_hist.snapshot("scheduled")
        seg_hist = self.scheduler.smetrics.pod_latency_segment
        seg_pre = {lv[0]: seg_hist.sum(*lv) for lv in seg_hist.label_sets()}
        # compile every deadline-cutting pod bucket OUTSIDE the measured
        # window (the headline bench does the same): without this the first
        # batch at each bucket pays a multi-second jit compile inside the
        # measurement and the sizer's latency model collapses. The sample
        # pod carries the MEASURED workload's shape (spread constraints,
        # affinity terms), so the warmed programs are the topology-mode
        # variants the real batches will actually run.
        warm = getattr(self.scheduler, "warm_buckets", None) if self._batched else None
        if warm is not None:
            spw = _pod_wrapper(10 ** 9, prefix, params)  # never stored
            if params.get("pvc"):
                # PVC workloads dispatch with the volume pre-pass mask — a
                # distinct trace signature warm_buckets compiles only when
                # the sample carries a volume
                spw.pvc("__warm__")
            warm(sample_pods=[spw.obj()])
        mcol = MetricsCollector(self.scheduler.smetrics.registry,
                                self.collect_metrics)
        mcol.start()
        col = self._collector(collector_interval)
        for j in range(count):
            self.store.create_pod(self._make_pod(
                prefix, dict(params, _gang_ordinal=j)
                if params.get("gang_size") else params))
            self._pod_counter += 1
        self._pump_dra()
        scheduled_before = scheduled_count()
        target = scheduled_before + count
        i = 0
        while scheduled_count() < target:
            progressed = self._cycle()
            col.maybe_sample(time.monotonic())
            if churn_every and i % churn_every == 0:
                self.churn(1)
            i += 1
            if not progressed and scheduled_count() < target:
                self.scheduler.queue.flush_backoff_completed()
                if len(self.scheduler.queue) == 0:
                    break  # some measured pods are genuinely unschedulable
        col.finish(time.monotonic())
        pods, seconds = col.window()
        self.measured_windows.append({"label": label, "pods": pods, "seconds": seconds})
        summary = col.summary()
        self.data_items.append(DataItem(data=summary, unit="pods/s", labels={"Name": label}))
        self._attempt_items(hist, lat_snaps, profile)
        if e2e_hist.count_since(e2e_snap, "scheduled"):
            self.data_items.append(DataItem(
                data={
                    "Perc50": e2e_hist.percentile_since(
                        e2e_snap, 0.50, "scheduled"),
                    "Perc90": e2e_hist.percentile_since(
                        e2e_snap, 0.90, "scheduled"),
                    "Perc99": e2e_hist.percentile_since(
                        e2e_snap, 0.99, "scheduled"),
                    "Count": float(e2e_hist.count_since(e2e_snap,
                                                        "scheduled")),
                },
                unit="s",
                labels={"Name": "pod_e2e_duration_seconds",
                        "result": "scheduled"}))
            seg_delta = {lv[0]: seg_hist.sum(*lv) - seg_pre.get(lv[0], 0.0)
                         for lv in seg_hist.label_sets()}
            seg_delta = {k: v for k, v in seg_delta.items() if v > 0}
            if seg_delta:
                self.data_items.append(DataItem(
                    data=seg_delta, unit="s",
                    labels={"Name": "pod_latency_segments"}))
        # per-phase percentiles over the measured window (extension points,
        # plugins, batch phases) — new DataItems with their own Name labels,
        # so headline consumers filtering on SchedulingThroughput /
        # scheduling_attempt_duration_seconds are untouched
        self.data_items.extend(mcol.collect())
        return summary

    # ---- slice-topology evidence ----

    def collect_slice_stats(self, label: str = "SliceStats") -> Dict[str, float]:
        """collectSliceStats op — slice-packing evidence from STORE truth,
        so oracle/tpu/wire rows are directly comparable: per-superpod
        fragmentation over free (pod-less) labeled hosts, contiguity of
        every bound slice gang (consecutive slots inside one superpod, one
        member per host), plus the slice wait/verdict metrics the batched
        paths observe and the sequential-fallback count (must stay 0 for
        slice batches). Assertions live in the tests; the harness measures."""
        from ..api.types import POD_GROUP_LABEL
        from ..ops.slice import (SLICE_LABEL, TOPO_SLOT_LABEL, TOPO_SUPERPOD_LABEL,
                                 fragmentation_host)

        coords: Dict[str, tuple] = {}
        for name, node in self.store.nodes.items():
            sp_s = node.meta.labels.get(TOPO_SUPERPOD_LABEL)
            pos_s = node.meta.labels.get(TOPO_SLOT_LABEL)
            if sp_s is not None and pos_s is not None:
                coords[name] = (int(sp_s), int(pos_s))
        occupied: Dict[str, int] = {}
        for p in self.store.pods.values():
            if p.spec.node_name:
                occupied[p.spec.node_name] = (
                    occupied.get(p.spec.node_name, 0) + 1)
        frag_max = frag_mean = 0.0
        if coords:
            names = sorted(coords)
            grid = (max(c[0] for c in coords.values()) + 1,
                    max(c[1] for c in coords.values()) + 1)
            rows = fragmentation_host(
                [coords[n][0] for n in names],
                [coords[n][1] for n in names],
                [True] * len(names),
                [occupied.get(n, 0) == 0 for n in names], grid)
            scores = [r["frag"] for r in rows]
            if scores:
                frag_max = max(scores)
                frag_mean = sum(scores) / len(scores)
        gangs: Dict[str, List[str]] = {}
        for p in self.store.pods.values():
            if (p.spec.node_name and p.meta.labels.get(SLICE_LABEL)
                    and p.meta.labels.get(POD_GROUP_LABEL)):
                gkey = (f"{p.meta.namespace}/"
                        f"{p.meta.labels[POD_GROUP_LABEL]}")
                gangs.setdefault(gkey, []).append(p.spec.node_name)
        violations = 0
        for gkey, members in gangs.items():
            cells = [coords.get(n) for n in members]
            if any(c is None for c in cells):
                violations += 1  # a member landed off the labeled torus
                continue
            cells.sort()
            sp_ids = {c[0] for c in cells}
            pos = [c[1] for c in cells]
            if (len(sp_ids) != 1 or len(set(pos)) != len(pos)
                    or pos[-1] - pos[0] != len(pos) - 1):
                violations += 1
        h = self.scheduler.smetrics.slice_wait_duration
        zero = 0  # all-time snapshot (MetricsCollector's zero form)
        data = {
            "FragmentationMax": frag_max,
            "FragmentationMean": frag_mean,
            "ContiguityViolations": float(violations),
            "BoundSliceGangs": float(len(gangs)),
            "SliceScheduled": float(h.count_since(zero, "scheduled")),
            "SliceRejected": float(h.count_since(zero, "rejected")),
            "SliceWaitP50": h.percentile_since(zero, 0.50, "scheduled"),
            "SliceWaitP99": h.percentile_since(zero, 0.99, "scheduled"),
            "FallbackScheduled": float(
                getattr(self.scheduler, "fallback_scheduled", 0)),
        }
        self.data_items.append(DataItem(
            data=data, unit="", labels={"Name": label}))
        return data

    # ---- the phases (round loops in perf/phases.py) ----

    def _quota_plugin(self):
        # the Scheduler owns the profile→plugin lookup (shared ledger, so
        # any profile's instance is THE ledger); don't re-implement it here
        lookup = getattr(self.scheduler, "_quota_plugin", None)
        return lookup() if lookup is not None else None

    def _arrive(self, r: int, entries, default_prefix: str = "") -> List[str]:
        """Round ``r``'s pods of ``entries``, each ``(index, mix entry,
        count)``: ``count`` pods of the entry's createPods params named
        ``<prefix>-m<index>r<r>-<n>`` (``prefix`` the entry's, else
        ``default_prefix``, else its namespace); then one resourceclaim
        controller round. Returns the pods' keys."""
        keys: List[str] = []
        for mi, m, count in entries:
            params = {k: v for k, v in m.items() if k not in ("count", "every", "prefix")}
            prefix = m["prefix"] if "prefix" in m else (default_prefix or params["namespace"])
            prefix = f"{prefix}-m{mi}r{r}"
            for j in range(count):
                p = self._make_pod(prefix, dict(params, _gang_ordinal=j)
                                   if params.get("gang_size") else params)
                self.store.create_pod(p)
                keys.append(p.key())
                self._pod_counter += 1
        self._pump_dra()
        return keys

    def _collector(self, interval: float) -> ThroughputCollector:
        col = ThroughputCollector(lambda: self.scheduler.metrics["scheduled"],
                                  interval=interval)
        col.start(time.monotonic())
        return col

    def _attempt_items(self, hist, lat_snaps: dict, profile: str) -> None:
        for res, snap in lat_snaps.items():
            if hist.count_since(snap, res, profile) == 0:
                continue
            self.data_items.append(DataItem(
                data={"Perc50": hist.percentile_since(snap, 0.50, res, profile),
                      "Perc90": hist.percentile_since(snap, 0.90, res, profile),
                      "Perc99": hist.percentile_since(snap, 0.99, res, profile)},
                unit="s",
                labels={"Name": "scheduling_attempt_duration_seconds", "result": res}))

    def soak_phase(self, rounds: int = 8, mix=(), churn_frac: float = 0.0,
                   flap: Optional[dict] = None, cycles_per_round: int = 40,
                   tick_s: float = 0.0, label: str = "SchedulingSoak",
                   collector_interval: float = 1.0) -> Dict[str, float]:
        """soakPhase op — the compressed multi-tenant production mix: per
        round, every ``mix`` entry lands its
        arrivals (plain pods, gangs, DRA claims, preemptors — any
        createPods param set, plus ``namespace``/``count``/``every``),
        the scheduler drives up to ``cycles_per_round`` cycles, and
        ``churn_frac`` of each tenant's soak-bound pods are deleted
        (freeing quota + node capacity → the targeted release moves).
        ``flap = {"round": r, "batches": n}`` scripts one device flap: the
        next ``n`` batch commits die through the real relay-death path
        (batched backends; no-op on ``oracle``).

        Evidence out (DataItems): SchedulingThroughput; attempt-latency
        percentiles; one ``SoakTenant`` item per namespace (admitted count,
        fair-share weight, queue-wait p50/p99 on the runner clock); one
        ``SoakInvariants`` item (quota-oversubscription violations sampled
        every cycle, degraded-seconds delta, breaker state, flap batches,
        comparer checks/mismatches). Assertions live in the tests — the
        harness measures."""
        from ..config.types import DEFAULT_SCHEDULER_NAME
        from .phases import soak_loop

        quota_plugin = self._quota_plugin()
        sched = self.scheduler
        # the soak's SLO evidence reads the per-tenant e2e histogram off
        # the REGISTRY: make sure the ledger is feeding it for this phase
        # — the loop's created-to-bound waits stay as the cross-check
        self._enable_ledger()
        tenants = sorted({str(m["namespace"]) for m in mix})
        tenant_hist = sched.smetrics.tenant_e2e_duration
        tenant_snaps = {ns: tenant_hist.snapshot(ns) for ns in tenants}
        hist = sched.smetrics.scheduling_attempt_duration
        profile = DEFAULT_SCHEDULER_NAME
        lat_snaps = {res: hist.snapshot(res, profile)
                     for res in ("scheduled", "unschedulable")}
        flap_round = None
        if flap is not None and self._batched and hasattr(sched, "relay_fault_fn"):
            flap_round = int(flap.get("round", rounds // 2))
        col = self._collector(collector_interval)
        out = soak_loop(
            self.store, sched, quota_plugin, self.now_fn, rounds,
            lambda r: self._arrive(r, [(mi, m, int(m["count"])) for mi, m in enumerate(mix)
                                       if not r % int(m.get("every", 1))]),
            tenants, cycle=self._cycle, cycles_per_round=cycles_per_round, tick_s=tick_s,
            churn_frac=churn_frac,
            breaker=getattr(sched, "relay_breaker", None) if self._batched else None,
            flap_round=flap_round, flap_batches=int((flap or {}).get("batches", 3)),
            on_cycle=lambda: col.maybe_sample(time.monotonic()))
        col.finish(time.monotonic())

        def pct(vals: List[float], q: float) -> float:
            if not vals:
                return 0.0
            s = sorted(vals)
            return s[min(len(s) - 1, max(0, int(q * len(s)) - 1))]

        self.data_items.append(DataItem(
            data=col.summary(), unit="pods/s", labels={"Name": label}))
        self._attempt_items(hist, lat_snaps, profile)
        pending = sched.queue.pending_pods()
        for ns in tenants:
            weight = (quota_plugin.weight_for(ns)
                      if quota_plugin is not None else None)
            snap = tenant_snaps[ns]
            self.data_items.append(DataItem(
                data={"Admitted": float(out["bound"][ns]),
                      "Weight": float(weight or 0.0),
                      "WaitP50": pct(out["waits"][ns], 0.50),
                      "WaitP99": pct(out["waits"][ns], 0.99),
                      # the registry-read SLO (scheduler_tenant_e2e_
                      # duration_seconds over this phase) — what a real
                      # operator's alert reads off /metrics; WaitP50/99
                      # above are the harness-internal cross-check
                      "E2eP50": tenant_hist.percentile_since(snap, 0.50, ns),
                      "E2eP99": tenant_hist.percentile_since(snap, 0.99, ns),
                      "E2eCount": float(
                          tenant_hist.count_since(snap, ns))},
                unit="", labels={"Name": "SoakTenant", "namespace": ns}))
        invariants = {
            "OversubscriptionViolations": float(out["oversubscription"]),
            "DegradedSeconds": float(out["degraded_s"]),
            "BreakerState": float(out["breaker_state"]),
            "FlapBatches": float(out["flap_batches"]),
            "ComparerChecks": float(out["comparer_checks"]),
            "ComparerMismatches": float(out["comparer_mismatches"]),
            "PendingAtEnd": float(sum(pending.values())),
            "GatedAtEnd": float(pending.get("gated", 0)),
        }
        self.data_items.append(DataItem(
            data=invariants, unit="", labels={"Name": "SoakInvariants"}))
        return invariants

    def borrow_phase(self, rounds: int = 8, mix=(), burst: Optional[dict] = None,
                     pool=(), cycles_per_round: int = 60, tick_s: float = 0.0,
                     label: str = "SchedulingBorrow",
                     collector_interval: float = 1.0) -> Dict[str, float]:
        """borrowPhase op — the asymmetric-cohort arrival script: an idle
        lender and a hungry borrower share one borrowing pool (the OFF arm of the A/B simply drops the cohort
        field from the quotas — same caps, same arrivals). Per round every
        ``mix`` entry lands its arrivals; at ``burst["round"]`` the lender
        wakes up with its own surge, which with borrowing ON must be
        funded by reclaim-by-preemption of the borrower's loans.

        Evidence out (DataItems): SchedulingThroughput; one BorrowTenant
        item per namespace (admitted count, borrowed peak, registry e2e
        p50/p99); one BorrowInvariants item — mean/peak pool utilization
        over every cycle (pods dimension summed over ``pool``), peak loans
        outstanding, reclaim passes executed, borrow-aware oversubscription
        violations sampled every cycle (own-cap net of loans AND cohort
        pool vs guaranteed). Assertions live in the tests — the harness
        measures."""
        from .phases import borrow_loop

        self._enable_ledger()
        tenants = sorted({str(m["namespace"]) for m in mix}
                         | ({str(burst["namespace"])} if burst else set()))
        burst_round = int(burst.get("round", rounds // 2)) if burst else -1

        def arrive(r: int) -> List[str]:
            entries = [m for m in mix if not r % int(m.get("every", 1))]
            if burst is not None and r == burst_round:
                entries.append({k: v for k, v in burst.items() if k != "round"})
            return self._arrive(r, [(mi, m, int(m["count"])) for mi, m in enumerate(entries)])

        col = self._collector(collector_interval)
        out = borrow_loop(self.store, self.scheduler, self._quota_plugin(), self.now_fn,
                          rounds, arrive, tenants, sorted(pool) or tenants, cycle=self._cycle,
                          cycles_per_round=cycles_per_round, tick_s=tick_s,
                          burst_round=burst_round,
                          on_cycle=lambda: col.maybe_sample(time.monotonic()))
        col.finish(time.monotonic())
        self.data_items.append(DataItem(
            data=col.summary(), unit="pods/s", labels={"Name": label}))
        for ns in tenants:
            self.data_items.append(DataItem(
                data=out["tenants"][ns], unit="",
                labels={"Name": "BorrowTenant", "namespace": ns}))
        self.data_items.append(DataItem(
            data=out["invariants"], unit="", labels={"Name": "BorrowInvariants"}))
        return out["invariants"]

    def replay_phase(self, rounds: int = 12, mix=(), curve=(),
                     bursts=None, shift_round: Optional[int] = None,
                     churn_frac: float = 0.25, cycles_per_round: int = 40,
                     tick_s: float = 0.0, label: str = "SchedulingReplay",
                     rebalance=None,
                     collector_interval: float = 1.0) -> Dict[str, float]:
        """replayPhase op — a compressed production trace: per round every
        ``mix`` entry lands ``count * curve[r] * burst`` arrivals (diurnal
        ``curve`` multipliers cycle; ``bursts = {round: mult}`` scripts
        storm rounds), ``shift_round`` rotates the tenants' counts (the
        tenant-mix shift), and ``churn_frac`` of each tenant's bound pods
        churn away per round — the fragmentation generator the rebalancer
        exists to fight. ``rebalance`` (False/None = off, True or a knob
        dict = on) attaches a Rebalancer and drives it every cycle.

        Evidence out: SchedulingThroughput (under the workload label); one
        ``ReplayTenant`` item per namespace with the registry-read e2e
        p50/p99 over the phase; one ``ReplayInvariants`` item — packing
        efficiency over time (mean 1-entropy over the steady-state second
        half, scored off store truth so oracle/tpu rows compare), final
        entropy/frag, the max tenant p99 (the JAX registry's bucket
        estimate), and the rebalancer's wave/migration/suspension
        counters. Assertions live in the tests and trend fences — the
        harness measures."""
        from ..controllers.rebalance import Rebalancer, score_from_snapshot
        from .phases import replay_loop

        sched = self.scheduler
        self._enable_ledger()
        tenants = sorted({str(m["namespace"]) for m in mix})
        curve = tuple(curve) or (0.4, 0.7, 1.0, 1.4, 1.6, 1.3, 0.9, 0.5)
        bursts = dict(bursts or {})
        base_counts = [int(m["count"]) for m in mix]

        rb: Optional[Rebalancer] = None
        if rebalance:
            kw = dict(rebalance) if isinstance(rebalance, dict) else {}
            if self._batched and hasattr(sched, "enable_rebalancer"):
                rb = sched.enable_rebalancer(now_fn=self.now_fn, **kw)
            else:
                # not attached: the loop's housekeeping would drive it too,
                # where the JAX sequential scheduler has no such hook
                rb = Rebalancer(sched, now_fn=self.now_fn, **kw)

        def arrive(r: int) -> List[str]:
            counts = list(base_counts)
            if shift_round is not None and r >= shift_round:
                counts = counts[1:] + counts[:1]  # the tenant-mix shift
            mult = curve[r % len(curve)] * float(bursts.get(r, 1.0))
            entries = []
            for mi, m in enumerate(mix):
                n_arrive = int(round(counts[mi] * mult))
                gs = int(m.get("gang_size") or 0)
                if gs:
                    # a partial gang can never reach quorum and would park in
                    # the queue forever — round arrivals down to whole gangs
                    n_arrive -= n_arrive % gs
                entries.append((mi, m, n_arrive))
            return self._arrive(r, entries)

        def score():
            sched.cache.update_snapshot(sched.snapshot)
            return score_from_snapshot(sched, self.device)

        col = self._collector(collector_interval)
        out = replay_loop(self.store, sched, self.now_fn, rounds, arrive, tenants,
                          cycle=self._cycle, cycles_per_round=cycles_per_round, score=score,
                          rebalancer=rb, tick_s=tick_s, churn_frac=churn_frac,
                          on_cycle=lambda: col.maybe_sample(time.monotonic()))
        col.finish(time.monotonic())
        self.data_items.append(DataItem(
            data=col.summary(), unit="pods/s", labels={"Name": label}))
        for ns in tenants:
            self.data_items.append(DataItem(
                data=out["tenants"][ns], unit="",
                labels={"Name": "ReplayTenant", "namespace": ns}))
        self.data_items.append(DataItem(
            data=out["invariants"], unit="", labels={"Name": "ReplayInvariants"}))
        return out["invariants"]

    def elastic_phase(self, rounds: int = 6, mix=(), storm_frac: float = 0.3,
                      drain_nodes: int = 2, spot_frac: float = 0.15,
                      cycles_per_round: int = 80, tick_s: float = 0.0,
                      settle_rounds: int = 2,
                      label: str = "SchedulingElastic",
                      collector_interval: float = 1.0) -> Dict[str, float]:
        """elasticPhase op — cluster elasticity under load: per
        round, the ``mix`` entries land their arrivals and the scheduler
        drives; then one chaos sub-phase rotates through (a) an autoscaler
        add/remove STORM (``storm_frac`` of the cluster drained, deleted,
        and replaced with NEW node names — the DeviceState shrink direction:
        tombstoned slots reused, vocab retention released), (b) a rolling
        DRAIN wave (``drain_nodes`` cordoned + evicted whole-gang, uncordoned
        next round), and (c) a mass SPOT reclamation (``spot_frac`` of nodes
        NoExecute-tainted through the taint-manager path, deleted, replaced).
        Evicted pods are recreated unbound, so the rebind waves are part of
        the measured load.

        Evidence out: SchedulingThroughput + attempt percentiles, and one
        ``ElasticInvariants`` DataItem — LostPods (created keys missing from
        the store at settle), Oversubscribed (per-node cpu/pods overcommit
        samples), RowCapacity (final DeviceState node axis — boundedness
        under churn), SlotReuses, NodesRemoved/NodesAdded, EvictedPods,
        UploadBytesSteady (last sync's upload bytes after the post-storm
        settle — 0 = delta elision recovered), HbmPeakBytes. Assertions
        live in the tests; the harness measures."""
        from ..controllers.drain import DrainOrchestrator
        from .phases import elastic_loop

        sched = self.scheduler
        drainer = DrainOrchestrator(self.store, metrics=sched.smetrics,
                                    queue=sched.queue, now_fn=self.now_fn)
        node_params = {k: v for k, v in getattr(self, "_elastic_node_params",
                                                {"zones": 10}).items() if k != "count"}
        col = self._collector(collector_interval)
        out = elastic_loop(
            self.store, sched, self.now_fn, rounds,
            lambda r: self._arrive(r, [(mi, m, int(m["count"])) for mi, m in enumerate(mix)
                                       if not r % int(m.get("every", 1))], "el"),
            cycle=self._cycle, cycles_per_round=cycles_per_round, drain=drainer,
            add_nodes=lambda count: self.create_nodes(count, **node_params),
            device_state=lambda: getattr(sched, "state", None) if self._batched else None,
            tick_s=tick_s, storm_frac=storm_frac, drain_nodes=drain_nodes,
            spot_frac=spot_frac, settle_rounds=settle_rounds,
            on_cycle=lambda: col.maybe_sample(time.monotonic()))
        col.finish(time.monotonic())
        self.data_items.append(DataItem(
            data=col.summary(), unit="pods/s", labels={"Name": label}))
        self.data_items.append(DataItem(
            data=out["invariants"], unit="", labels={"Name": "ElasticInvariants"}))
        return out["invariants"]

    # ---- config-driven entry ----

    def run_ops(self, ops: List[dict]) -> None:
        """Declarative op list (the YAML workload form)."""
        for op in ops:
            kind = op["opcode"]
            kwargs = {k: v for k, v in op.items() if k != "opcode"}
            if kind == "createNodes":
                self.create_nodes(**kwargs)
            elif kind == "createPods":
                self.create_pods(**kwargs)
            elif kind == "measurePods":
                self.measure(**kwargs)
            elif kind == "createNamespaces":
                self.create_namespaces(**kwargs)
            elif kind == "createQuota":
                self.create_quota(**kwargs)
            elif kind == "soakPhase":
                self.soak_phase(**kwargs)
            elif kind == "borrowPhase":
                self.borrow_phase(**kwargs)
            elif kind == "collectSliceStats":
                self.collect_slice_stats(**kwargs)
            elif kind == "replayPhase":
                self.replay_phase(**kwargs)
            elif kind == "elasticPhase":
                # remember the node shape for storm replacements
                self._elastic_node_params = dict(kwargs.pop("node_params", {})
                                                 or {"zones": 10})
                self.elastic_phase(**kwargs)
            elif kind == "barrier":
                self.barrier(**kwargs)
            elif kind == "churn":
                self.churn(**kwargs)
            elif kind == "sleep":
                time.sleep(kwargs.get("seconds", 0))
            else:
                raise ValueError(f"unknown opcode {kind!r}")


def run_workload(test_case: dict, backend: str = "oracle", **runner_kw) -> List[DataItem]:
    """One testCase dict: {name, schedulerConfig?, ops: [...]}; returns its
    DataItems (throughput + any scraped metrics). ``runner_kw`` go to
    ``Runner`` (``device``, ``batch_size``, ``now_fn``, ...)."""
    r = Runner(scheduler_config=test_case.get("schedulerConfig"), backend=backend, **runner_kw)
    try:
        r.run_ops(test_case["ops"])
    finally:
        r.close()
    for it in r.data_items:
        it.labels.setdefault("TestCase", test_case.get("name", "unnamed"))
        it.labels.setdefault("Backend", backend)
    return r.data_items
