"""The ttl, endpointslice, cronjob and attachdetach loops of
NewControllerInitializers (cmd/kube-controller-manager/app/
controllermanager.go:412); an own copy of
``kubernetes_tpu/controllers/extras.py``."""

from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional

from ..api.types import (
    CronJob,
    EndpointSlice,
    Job,
    OwnerReference,
    Service,
    VolumeAttachment,
)
from ..apiserver.store import Conflict
from .base import Controller
from .housekeeping import ready_addresses, service_keys_for_pod

# pkg/controller/ttl/ttl_controller.go:55 tiers: annotation granting kubelets
# a secret/configmap cache TTL scaled to cluster size
TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"
_TTL_TIERS = ((100, 0), (500, 15), (1000, 30), (5000, 60), (1 << 30, 300))


class TTLController(Controller):
    """ttl_controller: keep every node's ttl annotation at the tier for the
    current cluster size."""

    name = "ttl"
    watch_kinds = ("Node",)

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        # re-annotate EVERYONE only when the cluster-size tier flips (an
        # every-event full fan-out would be O(N²) under churn)
        tier = self._tier()
        if tier != getattr(self, "_last_tier", None):
            self._last_tier = tier
            return list(self.store.snapshot_map("Node")) + [obj.meta.name]
        return [obj.meta.name]

    def _tier(self) -> int:
        n = len(self.store.nodes)
        for bound, ttl in _TTL_TIERS:
            if n <= bound:
                return ttl
        return 300

    def reconcile(self, key: str) -> None:
        node = self.store.nodes.get(key)
        if node is None:
            return
        want = str(self._tier())
        if node.meta.annotations.get(TTL_ANNOTATION) == want:
            return
        new = dataclasses.replace(node)
        new.meta = dataclasses.replace(node.meta,
                                       annotations=dict(node.meta.annotations))
        new.meta.annotations[TTL_ANNOTATION] = want
        self.store.update_node(new)


MAX_ENDPOINTS_PER_SLICE = 100  # discovery.k8s.io default


class EndpointSliceController(Controller):
    """endpointslice controller: shard each Service's ready addresses into
    EndpointSlice objects of ≤ MAX_ENDPOINTS_PER_SLICE (the scalable form of
    Endpoints; one slice named {service}-{i})."""

    name = "endpointslice"
    watch_kinds = ("Service", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "Service":
            return [obj.meta.key()]
        return service_keys_for_pod(self.store, obj)

    # slices owned by the mirroring controller are not this controller's
    # (endpointslice controller skips managed-by != itself)
    MIRROR_LABEL = "endpointslice.kubernetes.io/managed-by"

    def reconcile(self, key: str) -> None:
        svc: Optional[Service] = self.store.services.get(key)
        existing = {k: s for k, s in self.store.snapshot_map("EndpointSlice").items()
                    if s.service == key and not s.meta.labels.get(self.MIRROR_LABEL)}
        if svc is None:
            for k in existing:
                self.store.delete_object("EndpointSlice", k)
            return
        if not svc.selector:
            # selector-less services are the mirroring controller's domain
            for k in existing:
                self.store.delete_object("EndpointSlice", k)
            return
        addrs = list(ready_addresses(self.store, svc))
        shards = [tuple(addrs[i:i + MAX_ENDPOINTS_PER_SLICE])
                  for i in range(0, len(addrs), MAX_ENDPOINTS_PER_SLICE)] or [()]
        wanted = {}
        for i, shard in enumerate(shards):
            name = f"{svc.meta.name}-{i}"
            wanted[f"{svc.meta.namespace}/{name}"] = shard
        for k in existing:
            if k not in wanted:
                self.store.delete_object("EndpointSlice", k)
        for k, shard in wanted.items():
            cur = self.store.endpoint_slices.get(k)
            if cur is not None and cur.addresses == shard:
                continue
            ns, name = k.split("/", 1)
            sl = EndpointSlice(service=key, addresses=shard)
            sl.meta.name = name
            sl.meta.namespace = ns
            if cur is None:
                self.store.create_object("EndpointSlice", sl)
            else:
                self.store.update_object("EndpointSlice", sl)


def parse_cron_field(field: str, lo: int, hi: int) -> Optional[frozenset]:
    """One cron field → allowed values (None = any). Supports '*', '*/N',
    'a,b,c', 'a-b'."""
    if field == "*":
        return None
    out = set()
    for part in field.split(","):
        if part.startswith("*/"):
            step = int(part[2:])
            out.update(range(lo, hi + 1, step))
        elif "-" in part:
            a, b = part.split("-", 1)
            out.update(range(int(a), int(b) + 1))
        else:
            out.add(int(part))
    return frozenset(out)


def cron_matches(schedule: str, epoch_s: float) -> bool:
    """5-field cron (minute hour dom month dow) against a UTC timestamp."""
    f = schedule.split()
    if len(f) != 5:
        raise ValueError(f"bad cron {schedule!r}")
    tm = _time.gmtime(epoch_s)
    fields = (
        (f[0], tm.tm_min, 0, 59),
        (f[1], tm.tm_hour, 0, 23),
        (f[2], tm.tm_mday, 1, 31),
        (f[3], tm.tm_mon, 1, 12),
        (f[4], (tm.tm_wday + 1) % 7, 0, 6),  # tm Mon=0..Sun=6 → cron Sun=0..Sat=6
    )
    for spec, val, lo, hi in fields:
        allowed = parse_cron_field(spec, lo, hi)
        if allowed is not None and val not in allowed:
            return False
    return True


class CronJobController(Controller):
    """cronjob controller: spawn a Job per matching minute (capability level:
    Forbid-style — at most one Job per schedule tick, tracked by the fired
    epoch-minute)."""

    name = "cronjob"
    watch_kinds = ("CronJob",)

    def __init__(self, store, factory, now_fn=_time.time):
        super().__init__(store, factory)
        self.now_fn = now_fn

    def tick(self) -> None:
        """Time-driven: enqueue CronJobs DUE this minute (the manager's sync
        loop is the reference's 10s-interval syncAll). Pre-checking here
        keeps settle() terminating — an idle CronJob enqueues nothing. A bad
        schedule is skipped (the manager also isolates tick errors)."""
        now = self.now_fn()
        minute = int(now // 60)
        for key, cj in self.store.snapshot_map("CronJob").items():
            try:
                due = (not cj.suspend and cj.template is not None
                       and cj.last_schedule_minute != minute
                       and cron_matches(cj.schedule, now))
            except ValueError:
                continue  # malformed schedule: never due
            if due:
                self.queue.add(key)

    def reconcile(self, key: str) -> None:
        cj: Optional[CronJob] = self.store.cron_jobs.get(key)
        if cj is None or cj.suspend or cj.template is None:
            return
        now = self.now_fn()
        minute = int(now // 60)
        try:
            due = minute != cj.last_schedule_minute and cron_matches(cj.schedule, now)
        except ValueError:
            return  # malformed schedule
        if not due:
            return
        job = Job(completions=cj.completions, parallelism=cj.parallelism,
                  template=cj.template)
        job.meta.name = f"{cj.meta.name}-{minute}"
        job.meta.namespace = cj.meta.namespace
        job.meta.owner_references = (OwnerReference(
            kind="CronJob", name=cj.meta.name, controller=True),)
        try:
            self.store.create_object("Job", job)
        except Conflict:
            pass  # already fired this minute by another manager
        # transient failures (quota, admission) propagate: the base requeues
        # with backoff and the minute is NOT marked fired, so the tick retries
        new = dataclasses.replace(cj, last_schedule_minute=minute)
        new.meta = dataclasses.replace(cj.meta)
        self.store.update_object("CronJob", new)


class AttachDetachController(Controller):
    """attachdetach controller (capability level): ensure a VolumeAttachment
    exists for every (bound PV, node) in use by a scheduled pod, and detach
    attachments no pod uses anymore."""

    name = "attachdetach"
    watch_kinds = ("Pod", "PersistentVolumeClaim")

    _KEY = "sync"  # single reconcile key: attachments are a global view

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        return [self._KEY]

    def reconcile(self, key: str) -> None:
        wanted = {}
        for pod in self.store.snapshot_map("Pod").values():
            if not pod.spec.node_name:
                continue
            for claim in pod.spec.volumes:
                pvc = self.store.pvcs.get(f"{pod.meta.namespace}/{claim}")
                if pvc is None or not pvc.bound_pv:
                    continue
                wanted[f"{pvc.bound_pv}^{pod.spec.node_name}"] = (
                    pvc.bound_pv, pod.spec.node_name)
        current = self.store.snapshot_map("VolumeAttachment")
        for name in current:
            if name not in wanted:
                self.store.delete_object("VolumeAttachment", name)
        for name, (pv, node) in wanted.items():
            if name in current:
                continue
            va = VolumeAttachment(pv_name=pv, node_name=node, attached=True)
            va.meta.name = name
            self.store.create_object("VolumeAttachment", va)
