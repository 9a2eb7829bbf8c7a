"""The device fabric (``kubernetes_tpu/backend/fabric.py``, whole): one
client in front of N ``DeviceService`` replicas, so that losing one device
process moves the loop to another replica instead of degrading it to the
sequential path. On the card every replica is a ``DeviceService(device=
"cuda")`` whose batches run the fused kernel.

The design is JAX's:

  * Per-endpoint replicas (``_Replica``). Each endpoint has its transport
    client (``WireClient`` or ``GrpcClient``), a probe client (one attempt,
    no retry budget) and a ``CircuitBreaker`` of threshold 1. That breaker
    does not gate calls to the active replica (the scheduler's own breaker
    owns whole-fabric degradation): it meters how often a down replica is
    re-probed with the Health verb.
  * Sticky selection. Every verb goes to the active replica. A replica that
    comes back becomes a healthy standby and is adopted again only through
    a later failover, whose first push meets the epoch check and re-seeds it
    with a full resync.
  * Failover (``_replica_lost``). The active replica fails a call: it is
    marked down (``replica_down``), the batch in flight is poisoned
    (``poison``), and the first standby whose Health answers is promoted
    (``failover``, strictly after the poison). The caller gets a
    ``FailoverError`` (transient): the scheduler requeues the pods through
    backoff; nothing is replayed, and the next push meets the standby's
    epoch, so the client's full resync seeds it under a fresh session.
    Pipelined lanes may see the death at once: one in-progress flag under
    the fabric lock runs the promotion once, and the other callers wait for
    it and fail against the new active. A permanent error fails over too,
    counted under ``reason="permanent"``. With no standby answering, the
    original error propagates, and the scheduler's breaker takes the pods to
    the sequential path; its half-open probe calls ``health()`` here, which
    answers from (or fails over to) the replica that came back first.
  * Warm standbys (``replication=True``). Every delta push the active
    acknowledges is folded into a replication state (node name -> newest
    wire entry); a worker thread (or ``replication_flush()``, which the
    tests call) pushes each healthy standby its dirty suffix, coalesced per
    node, or a full seed, under its own replicator session, and keeps that
    session and the scheduler client's (without its sessionGen) warm with
    heartbeats. At promote the standby's mirror already holds the rows, so
    the client's full resync uploads only what changed since.

Locking: plain locks. The fabric lock guards the selection state (active
index, in-progress flag, counters, probe clock), the replicator's condition
the replication state and the standbys' dirty sets. No transport call, probe
or replication push runs under either. A push racing a promotion is closed
without holding a lock across IO: the replicator re-checks the active index
under the fabric lock before clearing the replica's ``repl_idle``, and the
promotion flips the index first, then waits (bounded) for ``repl_idle``.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..testing import locktrace
from . import telemetry
from .circuit import CircuitBreaker
from .errors import (ConflictError, DeviceServiceError, FailoverError, PermanentDeviceError,
                     StaleEpochError)

API_VERSION = "ktpu/v1"

# how often a down replica is re-probed with Health (also the replica
# breaker's reset timeout, so allow() admits one probe per window)
DEFAULT_PROBE_INTERVAL_S = 5.0

# the failover journal /debug/fabric shows
LOG_CAPACITY = 64

# how long a replication push in flight is waited for (at a promotion, at close)
REPL_PUSH_WAIT_S = 10.0

_REPL_IDS = itertools.count(1)

_log = logging.getLogger(__name__)


class _Replica:
    """One endpoint (``:140``): its clients and health bookkeeping. One
    writer per field: the calling thread for health and epoch, the
    replicator for ``repl_*`` (the dirty sets under the replicator lock)."""

    __slots__ = ("index", "endpoint", "client", "probe", "breaker", "healthy", "epoch",
                 "last_error", "last_batch_id", "repl_idle", "repl_needs_full",
                 "repl_synced_seq", "repl_dirty", "repl_removed", "repl_ns_dirty",
                 "repl_epoch", "repl_session_gen", "repl_backoff_until", "repl_hb_at",
                 "repl_pushes", "repl_last_error")

    def __init__(self, index: int, endpoint: str, client, now_fn, probe_interval_s: float,
                 probe_client=None):
        self.index = index
        self.endpoint = endpoint
        self.client = client
        # probes of a maybe-dead replica run on the scheduling thread: the
        # probe client's single attempt bounds their cost
        self.probe = probe_client if probe_client is not None else client
        self.breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=probe_interval_s,
                                      now_fn=now_fn)
        self.healthy = True
        self.epoch: Optional[str] = None          # the last epoch it answered
        self.last_error = ""
        self.last_batch_id: Optional[str] = None  # the last batch it accepted
        # warm-standby replication
        self.repl_idle = threading.Event()        # clear: a push in flight
        self.repl_idle.set()
        self.repl_needs_full = True               # the next push seeds in full
        self.repl_synced_seq = 0                  # the fold sequence last acked
        self.repl_dirty: set = set()              # node names pending
        self.repl_removed: set = set()            # removals pending
        self.repl_ns_dirty: set = set()           # namespaces pending
        self.repl_epoch: Optional[str] = None
        self.repl_session_gen: Optional[int] = None
        self.repl_backoff_until = 0.0
        self.repl_hb_at = 0.0
        self.repl_pushes = 0
        self.repl_last_error = ""


class DeviceFabric:
    """The client-side fabric over N endpoints (``:188``), with the surface
    ``WireScheduler`` speaks: ``apply_deltas``, ``schedule_batch``,
    ``health``, ``heartbeat``, ``sessions_dump`` and the ``supports_*``
    flags. ``client_factory(endpoint, index)`` builds each replica's client,
    ``probe_client_factory`` its probe client. ``replication_worker=False``
    replicates only on ``replication_flush()``."""

    def __init__(self, endpoints: List[str], client_factory: Callable[[str, int], object],
                 probe_client_factory: Optional[Callable] = None, metrics=None,
                 now_fn=time.monotonic, probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
                 replication: bool = False, replication_worker: bool = True):
        if not endpoints:
            raise ValueError("DeviceFabric needs at least one endpoint")
        self.now_fn = now_fn
        self.probe_interval_s = probe_interval_s
        self.metrics = metrics
        self.replicas = [
            _Replica(i, ep, client_factory(ep, i), now_fn, probe_interval_s,
                     probe_client=(probe_client_factory(ep, i)
                                   if probe_client_factory is not None else None))
            for i, ep in enumerate(endpoints)]
        first = self.replicas[0].client
        # every replica speaks one transport
        self.supports_dra = getattr(first, "supports_dra", False)
        self.supports_health = getattr(first, "supports_health", False)
        self.supports_sessions = getattr(first, "supports_sessions", False)
        self._lock = locktrace.make_lock("DeviceFabric")
        # concurrent failers wait here while the first one promotes
        self._failover_cv = threading.Condition(self._lock)
        self._failover_inprogress = False
        self._active = 0
        self.failovers = 0
        self.log: deque = deque(maxlen=LOG_CAPACITY)
        self._last_probe = now_fn()
        # warm-standby replication
        self.replication_enabled = bool(replication) and len(endpoints) > 1
        self._repl_worker_enabled = replication_worker
        # serializes whole flush rounds (the worker against an explicit
        # flush); a round holds it across its transport calls by design
        self._repl_round_mutex = threading.Lock()
        self._repl_client_id = f"fabric-repl-{os.getpid():x}-{next(_REPL_IDS)}"
        self._repl_cv = threading.Condition(locktrace.make_lock("FabricReplicator"))
        self._repl_nodes: Dict[str, dict] = {}   # name -> newest wire entry
        self._repl_namespaces: Dict[str, dict] = {}
        self._repl_seq = 0                        # pushes folded from the active
        self._repl_pending = False
        self._repl_stopped = False
        self._repl_thread: Optional[threading.Thread] = None
        self._client_hb: Optional[str] = None     # the scheduler client to keep warm
        self.repl_rounds = 0
        if metrics is not None:
            metrics.fabric_active_replica.set(value=0)
            for rep in self.replicas:
                metrics.fabric_replica_health.set(rep.endpoint, value=1)

    def close(self) -> None:
        """Stop the replication worker and close clients that own a channel."""
        with self._repl_cv:
            self._repl_stopped = True
            self._repl_cv.notify_all()
        thread = self._repl_thread
        if thread is not None:
            thread.join(timeout=REPL_PUSH_WAIT_S)
        for rep in self.replicas:
            for c in {id(rep.client): rep.client, id(rep.probe): rep.probe}.values():
                close = getattr(c, "close", None)
                if close is not None:
                    close()

    # --------------------------------------------------------------- verbs

    def apply_deltas(self, payload: dict) -> dict:
        return self._call("apply_deltas", payload)

    def schedule_batch(self, payload: dict) -> dict:
        return self._call("schedule_batch", payload)

    def heartbeat(self, payload: dict) -> dict:
        return self._call("heartbeat", payload)

    def health(self) -> dict:
        return self._call("health", None)

    def sessions_dump(self) -> dict:
        """A read of the active replica's sessions, from the /debug serving
        thread: it never runs the failover machinery; a transport error
        goes to the caller."""
        return self.active_replica().client.sessions_dump()

    # ------------------------------------------------------------- routing

    def active_replica(self) -> _Replica:
        with self._lock:
            return self.replicas[self._active]

    def active_endpoint(self) -> str:
        return self.active_replica().endpoint

    def _call(self, verb: str, payload: Optional[dict]):
        """``verb`` on the active replica (``:299``), outside the lock."""
        rep = self.active_replica()
        fn = getattr(rep.client, verb)
        try:
            out = fn(payload) if payload is not None else fn()
        except (StaleEpochError, ConflictError):
            # verdicts of a healthy service: the client's own recovery
            raise
        except DeviceServiceError as exc:
            new, probe_out = self._replica_lost(rep, verb, payload, exc)
            if verb == "health":
                # the promotion probe's answer is a health answer
                return probe_out
            raise FailoverError(
                f"device replica {rep.endpoint} lost ({type(exc).__name__}: {exc}); promoted "
                f"standby {new.endpoint}; the next push re-seeds it via epoch resync",
                from_endpoint=rep.endpoint, to_endpoint=new.endpoint) from exc
        self._note_success(rep, verb, payload, out)
        self._maybe_probe_standbys()
        return out

    def _note_success(self, rep: _Replica, verb: str, payload: Optional[dict], out) -> None:
        rep.breaker.record_success()
        if isinstance(out, dict):
            rep.epoch = out.get("epoch", rep.epoch)
        if verb == "schedule_batch" and payload:
            rep.last_batch_id = payload.get("batchId", rep.last_batch_id)
        if self.replication_enabled:
            if verb == "apply_deltas" and payload:
                # the acknowledged push is the active's truth now
                self._repl_fold(payload)
            elif verb == "heartbeat" and payload:
                # the scheduler client whose standby sessions stay warm
                self._client_hb = payload.get("clientId") or self._client_hb
        if not rep.healthy:
            self._mark_health(rep, True)

    def _mark_health(self, rep: _Replica, up: bool) -> None:
        came_back = up and not rep.healthy
        rep.healthy = up
        if came_back:
            # its mirror went arbitrarily stale while it was away
            rep.repl_needs_full = True
        if self.metrics is not None:
            self.metrics.fabric_replica_health.set(rep.endpoint, value=1 if up else 0)

    # ------------------------------------------------------------ failover

    def _replica_lost(self, rep: _Replica, verb: str, payload: Optional[dict],
                      exc: DeviceServiceError):
        """Mark the active down, poison its batch, promote the first live
        standby (``:363``); returns ``(new_active, its_health_reply)``, or
        raises ``exc`` when no standby answers. Concurrent failers wait for
        the one promotion and fail against its result."""
        rep.breaker.record_failure(exc)
        rep.last_error = f"{type(exc).__name__}: {exc}"
        self._mark_health(rep, False)
        batch_id = (payload or {}).get("batchId")
        telemetry.event("replica_down", endpoint=rep.endpoint, verb=verb,
                        lastBatchId=rep.last_batch_id, error=str(exc)[:200])
        if batch_id:
            # the batch in flight dies with its replica; the scheduler
            # requeues its pods
            telemetry.event("poison", batchId=batch_id, endpoint=rep.endpoint,
                            pods=len((payload or {}).get("pods") or ()), error=str(exc)[:200])
        with self._lock:
            while self._failover_inprogress:
                self._failover_cv.wait()
            cur = self.replicas[self._active]
            if cur is not rep and cur.healthy:
                # another lane already failed over: no second promotion
                return cur, None
            self._failover_inprogress = True
        try:
            promoted = self._promote_standby(rep)
        finally:
            with self._lock:
                self._failover_inprogress = False
                self._failover_cv.notify_all()
        if promoted is None:
            raise exc
        new, probe_out = promoted
        reason = "permanent" if isinstance(exc, PermanentDeviceError) else "transient"
        if self.metrics is not None:
            self.metrics.fabric_failovers.inc(reason)
        # after the poison: the batch died, then the fabric moved on
        telemetry.event("failover", fromEndpoint=rep.endpoint, endpoint=new.endpoint,
                        batchId=batch_id, lastBatchId=rep.last_batch_id, reason=reason)
        return new, probe_out

    def _promote_standby(self, dead: _Replica):
        """Probe the standbys in rotation from the active with Health; the
        first to answer becomes active (``:424``). After the flip, wait
        (bounded) for a replication push to it that started before."""
        with self._lock:
            start = self._active
        n = len(self.replicas)
        for k in range(1, n):
            cand = self.replicas[(start + k) % n]
            if cand is dead or not cand.breaker.allow():
                continue
            try:
                out = cand.probe.health()
            except DeviceServiceError as probe_exc:
                cand.breaker.record_failure(probe_exc)
                cand.last_error = f"{type(probe_exc).__name__}: {probe_exc}"
                self._mark_health(cand, False)
                continue
            cand.breaker.record_success()
            cand.epoch = out.get("epoch", cand.epoch)
            self._mark_health(cand, True)
            with self._lock:
                self._active = cand.index
                self.failovers += 1
                self.log.append({"t": self.now_fn(), "from": dead.endpoint,
                                 "to": cand.endpoint, "error": dead.last_error})
            cand.repl_idle.wait(timeout=REPL_PUSH_WAIT_S)
            if self.metrics is not None:
                self.metrics.fabric_active_replica.set(value=cand.index)
            return cand, out
        return None

    def _maybe_probe_standbys(self) -> None:
        """Rate-limited rejoin (``:467``): probe the down standbys with
        Health; one that answers becomes a healthy standby, never active."""
        with self._lock:
            now = self.now_fn()
            if now - self._last_probe < self.probe_interval_s:
                return
            self._last_probe = now
            active = self._active
        for rep in [r for r in self.replicas if not r.healthy and r.index != active]:
            if not rep.breaker.allow():
                continue
            try:
                out = rep.probe.health()
            except DeviceServiceError as exc:
                rep.breaker.record_failure(exc)
                rep.last_error = f"{type(exc).__name__}: {exc}"
                continue
            rep.breaker.record_success()
            restarted = rep.epoch is not None and out.get("epoch") != rep.epoch
            rep.epoch = out.get("epoch", rep.epoch)
            self._mark_health(rep, True)
            telemetry.event("replica_rejoin", endpoint=rep.endpoint, restarted=restarted,
                            lastBatchId=rep.last_batch_id)

    # ------------------------------------------------- standby replication

    @staticmethod
    def _entry_name(entry: dict) -> Optional[str]:
        try:
            return entry["node"]["meta"]["name"]
        except (KeyError, TypeError):
            return None

    def _standby_targets(self) -> List[_Replica]:
        with self._lock:
            active = self._active
        return [r for r in self.replicas if r.index != active]

    def _repl_fold(self, payload: dict) -> None:
        """Fold one acknowledged push into the replication state and mark
        what changed dirty for every standby (``:512``); a node that changes
        five times while a standby lags ships once. No IO here."""
        targets = self._standby_targets()
        with self._repl_cv:
            pushed = set()
            for e in payload.get("nodes") or ():
                name = self._entry_name(e)
                if name is None:
                    continue
                pushed.add(name)
                prev = self._repl_nodes.get(name)
                self._repl_nodes[name] = e
                if prev is None or prev.get("gen") != e.get("gen"):
                    for rep in targets:
                        rep.repl_dirty.add(name)
                        rep.repl_removed.discard(name)
            removed = list(payload.get("removed") or ())
            if payload.get("full"):
                # a full push is the client's whole truth: what it omits is gone
                removed.extend(n for n in list(self._repl_nodes) if n not in pushed)
            for name in removed:
                self._repl_nodes.pop(name, None)
                for rep in targets:
                    rep.repl_dirty.discard(name)
                    rep.repl_removed.add(name)
            for ns, labels in (payload.get("namespaces") or {}).items():
                self._repl_namespaces[ns] = dict(labels)
                for rep in targets:
                    rep.repl_ns_dirty.add(ns)
            self._repl_seq += 1
            self._repl_pending = True
            if self._repl_worker_enabled and (self._repl_thread is None
                                              or not self._repl_thread.is_alive()):
                self._repl_thread = threading.Thread(target=self._repl_run,
                                                     name="ktpu-fabric-repl", daemon=True)
                self._repl_thread.start()
            self._repl_cv.notify_all()

    def _repl_run(self) -> None:
        """The replication worker (``:561``): a round when signalled, and
        every half second for the keep-warm heartbeats (metered on the
        fabric's clock)."""
        while True:
            with self._repl_cv:
                if not self._repl_pending and not self._repl_stopped:
                    self._repl_cv.wait(timeout=0.5)
                if self._repl_stopped:
                    return
                self._repl_pending = False
            try:
                self.replication_flush()
            except Exception:  # noqa: BLE001 - the worker outlives one failed round
                _log.exception("standby replication round failed")

    def replication_flush(self) -> int:
        """One replication round now (``:580``): the dirty suffix or a full
        seed to every healthy standby, keep-warm heartbeats, the lag
        gauges. Returns the pushes made."""
        if not self.replication_enabled:
            return 0
        with self._repl_round_mutex:
            self.repl_rounds += 1
            pushes = 0
            now = self.now_fn()
            for rep in self._standby_targets():
                if not rep.healthy or now < rep.repl_backoff_until:
                    continue
                pushes += self._replicate_to(rep)
                self._repl_keep_warm(rep, now)
            self._update_repl_lag()
            return pushes

    def _replicate_to(self, rep: _Replica) -> int:
        """Push one standby its pending suffix or a full seed (``:600``):
        the state is copied under the replicator lock, the call runs under
        no lock."""
        with self._repl_cv:
            full = rep.repl_needs_full
            if (not full and not rep.repl_dirty and not rep.repl_removed
                    and not rep.repl_ns_dirty and rep.repl_synced_seq == self._repl_seq):
                return 0
            if full:
                entries = list(self._repl_nodes.values())
                removed: List[str] = []
                namespaces = {ns: dict(v) for ns, v in self._repl_namespaces.items()}
                backup = None
            else:
                entries = [self._repl_nodes[n] for n in rep.repl_dirty if n in self._repl_nodes]
                removed = list(rep.repl_removed)
                namespaces = {ns: dict(self._repl_namespaces[ns]) for ns in rep.repl_ns_dirty
                              if ns in self._repl_namespaces}
                backup = (set(rep.repl_dirty), set(rep.repl_removed), set(rep.repl_ns_dirty))
            rep.repl_dirty.clear()
            rep.repl_removed.clear()
            rep.repl_ns_dirty.clear()
            target_seq = self._repl_seq
        payload = {"apiVersion": API_VERSION, "nodes": entries, "removed": removed,
                   "namespaces": namespaces, "clientId": self._repl_client_id,
                   "replicator": True}
        if full:
            payload["full"] = True
        elif rep.repl_epoch:
            payload["expectEpoch"] = rep.repl_epoch
        if rep.repl_session_gen is not None:
            payload["sessionGen"] = rep.repl_session_gen
        # no push starts once this replica is the active
        with self._lock:
            if self.replicas[self._active] is rep:
                self._repl_restore(rep, backup, full)
                return 0
            rep.repl_idle.clear()
        try:
            out = rep.probe.apply_deltas(payload)
        except StaleEpochError as exc:
            # the standby restarted under the replicator: reseed in full
            rep.repl_needs_full = True
            rep.repl_epoch = exc.epoch or None
            rep.repl_session_gen = None
            self._repl_signal()
            return 0
        except ConflictError:
            # the replicator's session was fenced, or a direct client's full
            # resync lapped it: rejoin fresh and reseed in full
            rep.repl_session_gen = None
            rep.repl_needs_full = True
            self._repl_signal()
            return 0
        except DeviceServiceError as exc:
            rep.repl_last_error = f"{type(exc).__name__}: {exc}"
            rep.repl_backoff_until = self.now_fn() + self.probe_interval_s
            self._repl_restore(rep, backup, full)
            return 0
        finally:
            rep.repl_idle.set()
        rep.repl_epoch = out.get("epoch", rep.repl_epoch)
        rep.repl_session_gen = out.get("sessionGen", rep.repl_session_gen)
        rep.repl_needs_full = False
        rep.repl_synced_seq = target_seq
        rep.repl_pushes += 1
        rep.repl_last_error = ""
        if self.metrics is not None or telemetry.get() is not None:
            # the payload as JSON: the shape of a full seed against a dirty
            # suffix (the promote's evidence is the DeviceState's upload
            # bytes); serialized only when someone reads it
            kind = "full" if full else "delta"
            nbytes = len(json.dumps(payload).encode())
            if self.metrics is not None:
                self.metrics.standby_resync_bytes.inc(kind, value=float(nbytes))
            telemetry.event("replication", endpoint=rep.endpoint, seq=target_seq,
                            nodes=len(entries), removed=len(removed), full=full, bytes=nbytes)
        return 1

    def _repl_restore(self, rep: _Replica, backup, full: bool) -> None:
        """Give a failed round's dirty sets back (``:695``); a failed full
        push keeps ``repl_needs_full``."""
        with self._repl_cv:
            if full:
                rep.repl_needs_full = True
            elif backup is not None:
                dirty, removed, ns_dirty = backup
                rep.repl_dirty |= dirty
                rep.repl_removed |= removed
                rep.repl_ns_dirty |= ns_dirty

    def _repl_signal(self) -> None:
        with self._repl_cv:
            self._repl_pending = True
            self._repl_cv.notify_all()

    def _repl_keep_warm(self, rep: _Replica, now: float) -> None:
        """Keep-warm heartbeats to a standby (``:712``), once per probe
        interval: the replicator's session, whose node claims keep the warm
        DeviceState alive, and the scheduler client's, without its
        sessionGen (the standby mints its own), so that the first commit
        after a failover meets a live lease."""
        if now - rep.repl_hb_at < self.probe_interval_s:
            return
        rep.repl_hb_at = now
        for cid in (self._repl_client_id, self._client_hb):
            if not cid:
                continue
            payload = {"apiVersion": API_VERSION, "clientId": cid}
            if cid == self._repl_client_id:
                payload["replicator"] = True
                if rep.repl_session_gen is not None:
                    payload["sessionGen"] = rep.repl_session_gen
            try:
                out = rep.probe.heartbeat(payload)
            except ConflictError:
                if cid == self._repl_client_id:
                    rep.repl_session_gen = None
                continue
            except DeviceServiceError as exc:
                rep.repl_last_error = f"{type(exc).__name__}: {exc}"
                rep.repl_backoff_until = self.now_fn() + self.probe_interval_s
                return
            if cid == self._repl_client_id:
                rep.repl_session_gen = out.get("sessionGen", rep.repl_session_gen)

    def _update_repl_lag(self) -> None:
        if self.metrics is None:
            return
        with self._repl_cv:
            seq = self._repl_seq
        with self._lock:
            active = self._active
        for rep in self.replicas:
            lag = 0 if rep.index == active else max(0, seq - rep.repl_synced_seq)
            self.metrics.standby_replication_lag.set(rep.endpoint, value=lag)

    def replication_lag(self, rep: _Replica) -> int:
        """Delta generations ``rep``'s mirror lags the active's stream."""
        with self._repl_cv:
            return max(0, self._repl_seq - rep.repl_synced_seq)

    # --------------------------------------------------------------- debug

    def dump(self) -> dict:
        """The /debug/fabric body (``:765``): the replica table, the
        failover journal and the replication state."""
        with self._lock:
            active = self._active
            failovers = self.failovers
            log = list(self.log)
        with self._repl_cv:
            repl_seq = self._repl_seq
        replicas = [{
            "endpoint": rep.endpoint,
            "active": rep.index == active,
            "healthy": rep.healthy,
            "epoch": rep.epoch,
            "lastBatchId": rep.last_batch_id,
            "lastError": rep.last_error,
            "breaker": rep.breaker.dump(),
            "replication": {
                "syncedSeq": rep.repl_synced_seq,
                "lag": 0 if rep.index == active else max(0, repl_seq - rep.repl_synced_seq),
                "needsFull": rep.repl_needs_full,
                "pushes": rep.repl_pushes,
                "lastError": rep.repl_last_error,
            },
        } for rep in self.replicas]
        return {
            "enabled": True,
            "active": self.replicas[active].endpoint,
            "activeIndex": active,
            "replicaCount": len(self.replicas),
            "failovers": failovers,
            "probeIntervalS": self.probe_interval_s,
            "replication": {"enabled": self.replication_enabled, "seq": repl_seq,
                            "clientId": self._repl_client_id, "rounds": self.repl_rounds},
            "replicas": replicas,
            "log": log,
        }
