"""Workload controllers: ReplicaSet, Deployment, StatefulSet, DaemonSet, Job
(pkg/controller/{replicaset,deployment,statefulset,daemon,job}); an own
copy of ``kubernetes_tpu/controllers/workloads.py``.

Capability-level reconcilers with the reference's core semantics: selector-
matched, controller-owned pod management; Deployment delegates to a
ReplicaSet; StatefulSet keeps ordinal-stable names and creates in order;
DaemonSet places one pod per eligible node (scheduler still binds it);
Job runs pods to ``completions`` with ``parallelism`` in flight.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..api.types import (
    DaemonSet,
    Deployment,
    Job,
    LabelSelector,
    ObjectMeta,
    OwnerReference,
    Pod,
    ReplicaSet,
    StatefulSet,
)
from .base import Controller


def _instantiate(template: Pod, name: str, namespace: str,
                 owner_kind: str, owner_name: str, extra_labels=None) -> Pod:
    pod = template.clone()
    pod.meta = dataclasses.replace(
        template.meta,
        name=name,
        namespace=namespace,
        labels={**template.meta.labels, **(extra_labels or {})},
        owner_references=(OwnerReference(kind=owner_kind, name=owner_name, controller=True),),
        resource_version=0,
    )
    pod.spec.node_name = ""
    pod.status.phase = "Pending"
    return pod


def _owned_pods(store, namespace: str, owner_kind: str, owner_name: str) -> List[Pod]:
    out = []
    for pod in store.snapshot_map("Pod").values():
        if pod.meta.namespace != namespace:
            continue
        ref = pod.meta.controller_of()
        if ref is not None and ref.kind == owner_kind and ref.name == owner_name:
            out.append(pod)
    return out


class ReplicaSetController(Controller):
    """Reconcile |owned pods| to spec.replicas (replica_set.go syncReplicaSet:
    create missing with owner refs, delete surplus; terminating pods don't
    count toward the active set)."""

    name = "replicaset"
    watch_kinds = ("ReplicaSet", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "ReplicaSet":
            return [obj.meta.key()]
        ref = obj.meta.controller_of()
        if ref is not None and ref.kind == "ReplicaSet":
            return [f"{obj.meta.namespace}/{ref.name}"]
        return []

    def reconcile(self, key: str) -> None:
        rs: Optional[ReplicaSet] = self.store.get_replica_set(key)
        if rs is None or rs.meta.deletion_timestamp:
            return
        owned = [p for p in _owned_pods(self.store, rs.meta.namespace, "ReplicaSet", rs.meta.name)
                 if not p.meta.deletion_timestamp]
        # FilterActivePods (pkg/controller/controller_utils.go:922): a
        # Succeeded/Failed pod (e.g. evicted by the kubelet) no longer
        # counts toward the replica set — it must be replaced
        pods = [p for p in owned if p.status.phase not in ("Succeeded", "Failed")]
        diff = rs.replicas - len(pods)
        if diff > 0:
            # terminal pods still hold their names: never reuse one
            used = {p.meta.name for p in owned}
            i = 0
            while diff > 0:
                name = f"{rs.meta.name}-{i}"
                i += 1
                if name in used:
                    continue
                self.store.create_pod(
                    _instantiate(rs.template or Pod(), name, rs.meta.namespace,
                                 "ReplicaSet", rs.meta.name)
                )
                diff -= 1
        elif diff < 0:
            # prefer deleting unscheduled, then newest (controller_utils
            # ActivePods sort, simplified)
            pods.sort(key=lambda p: (bool(p.spec.node_name), -p.meta.resource_version))
            for p in pods[: -rs.replicas] if rs.replicas else pods:
                self.store.delete_pod(p.meta.key())


def _template_hash(template) -> str:
    """Stable short pod-template hash (the reference's pod-template-hash
    label that names per-revision ReplicaSets)."""
    import hashlib
    import json

    from ..api.codec import to_wire

    blob = json.dumps(to_wire(template) if template is not None else {},
                      sort_keys=True)
    return hashlib.md5(blob.encode()).hexdigest()[:8]


def _pod_available(p: Pod) -> bool:
    """Running counts; a bound-but-Pending pod counts in scheduler-only
    environments (no kubelet to flip the phase). Failed/Succeeded never do —
    node_name survives termination."""
    return (p.status.phase == "Running"
            or (p.status.phase == "Pending" and bool(p.spec.node_name)))


class DeploymentController(Controller):
    """Deployment → per-revision ReplicaSets named <deploy>-<templatehash>;
    RollingUpdate walks the surge/unavailable windows
    (deployment_controller.go syncDeployment + rolling.go reconcileNew/
    OldReplicaSets), Recreate tears old revisions to zero first."""

    name = "deployment"
    watch_kinds = ("Deployment", "ReplicaSet", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "Deployment":
            return [obj.meta.key()]
        if kind == "ReplicaSet":
            dref = obj.meta.controller_of()
            if dref is not None and dref.kind == "Deployment":
                return [f"{obj.meta.namespace}/{dref.name}"]
            return []
        # pod → owning RS → owning Deployment (ready counts gate the rollout)
        ref = obj.meta.controller_of()
        if ref is None or ref.kind != "ReplicaSet":
            return []
        rs = self.store.get_replica_set(f"{obj.meta.namespace}/{ref.name}")
        if rs is None:
            return []
        dref = rs.meta.controller_of()
        if dref is None or dref.kind != "Deployment":
            return []
        return [f"{obj.meta.namespace}/{dref.name}"]

    def _owned_replica_sets(self, dep: Deployment) -> List[ReplicaSet]:
        out = []
        for rs in self.store.snapshot_map("ReplicaSet").values():
            if rs.meta.namespace != dep.meta.namespace:
                continue
            ref = rs.meta.controller_of()
            if ref is not None and ref.kind == "Deployment" and ref.name == dep.meta.name:
                out.append(rs)
        return out

    def _set_replicas(self, rs: ReplicaSet, n: int) -> None:
        if rs.replicas == n:
            return
        new_rs = dataclasses.replace(rs, replicas=n)
        new_rs.meta = dataclasses.replace(rs.meta)
        self.store.update_object("ReplicaSet", new_rs)
        rs.replicas = n  # keep the local view current within this reconcile

    def _pods_by_rs(self, dep: Deployment):
        """ONE snapshot scan → {rs name: (alive, available)} counts (reconcile
        would otherwise rescan the pod map per RS per metric)."""
        counts: dict = {}
        for p in self.store.snapshot_map("Pod").values():
            if p.meta.namespace != dep.meta.namespace:
                continue
            ref = p.meta.controller_of()
            if ref is None or ref.kind != "ReplicaSet":
                continue
            alive = p.status.phase in ("Pending", "Running")
            avail = _pod_available(p)
            a, v = counts.get(ref.name, (0, 0))
            counts[ref.name] = (a + (1 if alive else 0), v + (1 if avail else 0))
        return counts

    def reconcile(self, key: str) -> None:
        dep: Optional[Deployment] = self.store.get_object("Deployment", key)
        if dep is None:
            return
        # apps/v1 validation rejects surge=0 + unavailable=0 at admission (a
        # rollout could never progress); clamp the same way here
        max_surge = dep.max_surge
        max_unavailable = dep.max_unavailable
        if max_surge == 0 and max_unavailable == 0:
            max_unavailable = 1
        want_hash = _template_hash(dep.template)
        new_name = f"{dep.meta.name}-{want_hash}"
        owned = self._owned_replica_sets(dep)
        new_rs = next((rs for rs in owned if rs.meta.name == new_name), None)
        olds = [rs for rs in owned if rs.meta.name != new_name]
        counts = self._pods_by_rs(dep)

        def alive(rs):
            return counts.get(rs.meta.name, (0, 0))[0]

        def avail(rs):
            return counts.get(rs.meta.name, (0, 0))[1]

        if new_rs is None:
            # Recreate waits for the old revision to fully terminate before
            # the new one exists (deployment/recreate.go)
            if olds and dep.strategy == "Recreate":
                for rs in olds:
                    self._set_replicas(rs, 0)
                if any(alive(rs) > 0 for rs in olds):
                    return
            initial = dep.replicas
            if olds:  # RollingUpdate: new revision starts inside the surge
                total = sum(alive(rs) for rs in olds)
                initial = max(0, min(dep.replicas,
                                     dep.replicas + max_surge - total))
            # revision annotation: 1 + the highest existing revision (the
            # deployment controller's MaxRevision bookkeeping; kubectl
            # rollout history/status reads it)
            next_rev = 1 + max(
                (int(rs.meta.annotations.get(
                    "deployment.kubernetes.io/revision", 0) or 0)
                 for rs in olds), default=0)
            new_rs = ReplicaSet(
                meta=ObjectMeta(
                    name=new_name, namespace=dep.meta.namespace,
                    annotations={"deployment.kubernetes.io/revision": str(next_rev)},
                    owner_references=(OwnerReference(
                        kind="Deployment", name=dep.meta.name, controller=True),),
                ),
                selector=dep.selector,
                replicas=initial,
                template=dep.template,
            )
            self.store.create_replica_set(new_rs)
            # fall through: with max_surge=0 the new RS starts at 0 replicas
            # and only the old-RS scale-down below can open headroom — an
            # early return here would stall the rollout forever

        if not olds:
            self._set_replicas(new_rs, dep.replicas)
            return

        if dep.strategy == "Recreate":
            for rs in olds:
                self._set_replicas(rs, 0)
            if all(alive(rs) == 0 for rs in olds):
                self._set_replicas(new_rs, dep.replicas)
                for rs in olds:
                    self.store.delete_object("ReplicaSet", rs.meta.key())
            return

        # RollingUpdate (rolling.go): scale new up within the surge window,
        # old down within the availability window. Counts must cover work the
        # RS controller hasn't materialized yet: a scaled-up RS whose pods
        # aren't created counts its replicas (else the surge is allocated
        # twice), and a scaled-down RS whose pods aren't deleted yet has
        # those removals charged against the availability budget (else the
        # window is spent twice).
        def intended(rs):
            return max(alive(rs), rs.replicas)

        total_pods = intended(new_rs) + sum(intended(rs) for rs in olds)
        available = avail(new_rs) + sum(avail(rs) for rs in olds)
        inflight_removals = sum(max(0, alive(rs) - rs.replicas) for rs in olds)
        max_total = dep.replicas + max_surge
        min_available = dep.replicas - max_unavailable

        headroom = max_total - total_pods
        if headroom > 0 and new_rs.replicas < dep.replicas:
            self._set_replicas(new_rs, min(dep.replicas, new_rs.replicas + headroom))
        can_remove = available - min_available - inflight_removals
        for rs in sorted(olds, key=lambda r: r.meta.name):
            if can_remove <= 0:
                break
            down = min(rs.replicas, can_remove)
            if down > 0:
                self._set_replicas(rs, rs.replicas - down)
                can_remove -= down
        for rs in olds:
            if rs.replicas == 0 and alive(rs) == 0:
                self.store.delete_object("ReplicaSet", rs.meta.key())


class StatefulSetController(Controller):
    """Ordinal-stable pods <name>-0..N-1, created in order only when the
    previous ordinal is running (stateful_set_control.go's monotonic scale-up),
    scaled down from the top."""

    name = "statefulset"
    watch_kinds = ("StatefulSet", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "StatefulSet":
            return [obj.meta.key()]
        ref = obj.meta.controller_of()
        if ref is not None and ref.kind == "StatefulSet":
            return [f"{obj.meta.namespace}/{ref.name}"]
        return []

    def reconcile(self, key: str) -> None:
        ss: Optional[StatefulSet] = self.store.get_stateful_set(key)
        if ss is None:
            return
        existing = {p.meta.name: p for p in
                    _owned_pods(self.store, ss.meta.namespace, "StatefulSet", ss.meta.name)}
        # scale down from the highest ordinal
        for i in range(ss.replicas, len(existing) + ss.replicas + 1):
            name = f"{ss.meta.name}-{i}"
            if name in existing:
                self.store.delete_pod(f"{ss.meta.namespace}/{name}")
        # scale up strictly in ordinal order; stop at the first not-yet-running
        for i in range(ss.replicas):
            name = f"{ss.meta.name}-{i}"
            pod = existing.get(name)
            if pod is None:
                self.store.create_pod(
                    _instantiate(ss.template or Pod(), name, ss.meta.namespace,
                                 "StatefulSet", ss.meta.name)
                )
                return
            if pod.status.phase != "Running":
                return


def _pin_to_node(pod: Pod, node_name: str) -> Pod:
    """Pin via required nodeAffinity on metadata.name — how the reference's
    daemonset controller targets nodes since scheduler-managed daemon pods
    (daemon/util/daemonset_util.go ReplaceDaemonSetPodNodeNameNodeAffinity)."""
    from ..api.types import Affinity, NodeAffinity, NodeSelector, NodeSelectorTerm

    old = pod.spec.affinity  # shared with the template: build a fresh Affinity
    pod.spec.affinity = Affinity(
        node_affinity=NodeAffinity(
            required=NodeSelector(terms=(NodeSelectorTerm(match_fields_name=node_name),))
        ),
        pod_affinity=old.pod_affinity if old else None,
        pod_anti_affinity=old.pod_anti_affinity if old else None,
    )
    return pod


class DaemonSetController(Controller):
    """One pod per node (daemon/daemonset.go), each pinned by a
    metadata.name nodeAffinity term so the scheduler still places it."""

    name = "daemonset"
    watch_kinds = ("DaemonSet", "Node", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "DaemonSet":
            return [obj.meta.key()]
        if kind == "Pod":
            ref = obj.meta.controller_of()
            if ref is not None and ref.kind == "DaemonSet":
                return [f"{obj.meta.namespace}/{ref.name}"]
            return []
        # node events touch every daemonset
        return [ds.meta.key() for ds in self.store.snapshot_map("DaemonSet").values()]

    @staticmethod
    def _pinned(pod: Pod) -> str:
        aff = pod.spec.affinity
        if aff is not None and aff.node_affinity is not None and aff.node_affinity.required:
            for term in aff.node_affinity.required.terms:
                if term.match_fields_name is not None:
                    return term.match_fields_name
        return pod.spec.node_name

    def reconcile(self, key: str) -> None:
        ds: Optional[DaemonSet] = self.store.get_object("DaemonSet", key)
        if ds is None:
            return
        nodes = set(self.store.snapshot_map("Node"))
        have = {}
        for p in _owned_pods(self.store, ds.meta.namespace, "DaemonSet", ds.meta.name):
            have[self._pinned(p)] = p
        for node_name in sorted(nodes - set(have)):
            pod = _instantiate(ds.template or Pod(), f"{ds.meta.name}-{node_name}",
                               ds.meta.namespace, "DaemonSet", ds.meta.name)
            self.store.create_pod(_pin_to_node(pod, node_name))
        for pinned, p in have.items():
            if pinned not in nodes:
                self.store.delete_pod(p.meta.key())


class JobController(Controller):
    """Run pods until ``completions`` succeed, at most ``parallelism`` active;
    give up after ``backoffLimit`` failures or ``activeDeadlineSeconds``
    (job/job_controller.go syncJob)."""

    name = "job"
    watch_kinds = ("Job", "Pod")

    def __init__(self, store, factory, now_fn=None):
        super().__init__(store, factory)
        import time as _time

        self.now_fn = now_fn or _time.monotonic

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "Job":
            return [obj.meta.key()]
        ref = obj.meta.controller_of()
        if ref is not None and ref.kind == "Job":
            return [f"{obj.meta.namespace}/{ref.name}"]
        return []

    def tick(self) -> None:
        """Deadline enforcement needs time, not events."""
        now = self.now_fn()
        for key, job in self.store.snapshot_map("Job").items():
            if (not job.condition and job.active_deadline_seconds is not None
                    and job.start_time
                    and now - job.start_time > job.active_deadline_seconds):
                self.queue.add(key)

    def _update(self, job: Job, **changes) -> Job:
        new_job = dataclasses.replace(job, **changes)
        new_job.meta = dataclasses.replace(job.meta)
        self.store.update_object("Job", new_job)
        return new_job

    def _fail_job(self, job: Job, pods, reason: str) -> None:
        for p in pods:
            if p.status.phase in ("Pending", "Running"):
                self.store.delete_pod(p.meta.key())
        self._update(job, condition="Failed", failed_reason=reason,
                     completion_time=self.now_fn())

    def reconcile(self, key: str) -> None:
        job: Optional[Job] = self.store.get_object("Job", key)
        if job is None:
            return
        if not job.start_time:
            job = self._update(job, start_time=self.now_fn())
        pods = _owned_pods(self.store, job.meta.namespace, "Job", job.meta.name)
        succeeded = sum(1 for p in pods if p.status.phase == "Succeeded")
        failed = sum(1 for p in pods if p.status.phase == "Failed")
        active = [p for p in pods if p.status.phase in ("Pending", "Running")]
        if succeeded != job.succeeded or failed != job.failed:
            job = self._update(job, succeeded=succeeded, failed=failed)
        if job.condition:
            return  # terminal
        if (job.active_deadline_seconds is not None and job.start_time
                and self.now_fn() - job.start_time > job.active_deadline_seconds):
            self._fail_job(job, pods, "DeadlineExceeded")
            return
        if failed > job.backoff_limit:
            self._fail_job(job, pods, "BackoffLimitExceeded")
            return
        if succeeded >= job.completions:
            self._update(job, condition="Complete",
                         completion_time=self.now_fn())
            return
        want_active = min(job.parallelism, job.completions - succeeded)
        existing_names = {p.meta.name for p in pods}
        i = 0
        while len(active) < want_active:
            name = f"{job.meta.name}-{i}"
            i += 1
            if name in existing_names:
                continue
            # retries reuse fresh names past the failed ordinals
            if i > job.completions + failed + 8:
                break
            pod = _instantiate(job.template or Pod(), name, job.meta.namespace,
                               "Job", job.meta.name)
            self.store.create_pod(pod)
            active.append(pod)


class ReplicationControllerController(Controller):
    """pkg/controller/replication: the legacy map-selector twin of the
    ReplicaSet controller (replica_set.go is shared by both upstream)."""

    name = "replicationcontroller"
    watch_kinds = ("ReplicationController", "Pod")

    def keys_for(self, kind: str, obj, event: str) -> List[str]:
        if kind == "ReplicationController":
            return [obj.meta.key()]
        ref = obj.meta.controller_of()
        if ref is not None and ref.kind == "ReplicationController":
            return [f"{obj.meta.namespace}/{ref.name}"]
        return []

    def reconcile(self, key: str) -> None:
        rc = self.store.get_replication_controller(key)
        if rc is None or rc.meta.deletion_timestamp:
            return
        pods = [p for p in _owned_pods(self.store, rc.meta.namespace,
                                       "ReplicationController", rc.meta.name)
                if not p.meta.deletion_timestamp]
        diff = rc.replicas - len(pods)
        if diff > 0:
            used = {p.meta.name for p in pods}
            i = 0
            while diff > 0:
                name = f"{rc.meta.name}-{i}"
                i += 1
                if name in used:
                    continue
                self.store.create_pod(
                    _instantiate(rc.template or Pod(), name, rc.meta.namespace,
                                 "ReplicationController", rc.meta.name))
                diff -= 1
        elif diff < 0:
            pods.sort(key=lambda p: (bool(p.spec.node_name), -p.meta.resource_version))
            for p in pods[: -rc.replicas] if rc.replicas else pods:
                self.store.delete_pod(p.meta.key())
