"""Leader election on a Lease lock (client-go tools/leaderelection/
leaderelection.go:177 LeaderElector; an own copy of
``kubernetes_tpu/client/leaderelection.py``).

Active-passive HA: candidates race to create/update one Lease object via the
store's optimistic-concurrency update; the holder renews every
retry_period, others take over when renew_time + lease_duration passes
(leaderelection.go tryAcquireOrRenew). Crash-only: a dead leader's lease
simply expires.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..api.types import Lease, ObjectMeta
from ..apiserver.store import Conflict, NotFound

logger = logging.getLogger(__name__)


@dataclass
class LeaderElectionConfig:
    lock_name: str = "kube-scheduler"
    lock_namespace: str = "kube-system"
    identity: str = "scheduler-0"
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0


class LeaderElector:
    def __init__(self, store, config: LeaderElectionConfig,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 now_fn=time.monotonic):
        self.store = store
        self.config = config
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.now_fn = now_fn
        self._leading = False
        self._last_renew = 0.0

    @property
    def _key(self) -> str:
        return f"{self.config.lock_namespace}/{self.config.lock_name}"

    def is_leader(self) -> bool:
        return self._leading

    def _expired(self, lease: Lease) -> bool:
        return self.now_fn() > lease.renew_time + lease.lease_duration_seconds

    def try_acquire_or_renew(self) -> bool:
        """One acquire/renew attempt (leaderelection.go:322
        tryAcquireOrRenew); returns True while holding the lock."""
        cfg = self.config
        now = self.now_fn()
        lease = self.store.get_lease(self._key)
        if lease is None:
            new = Lease(
                meta=ObjectMeta(name=cfg.lock_name, namespace=cfg.lock_namespace),
                holder_identity=cfg.identity,
                lease_duration_seconds=cfg.lease_duration,
                acquire_time=now,
                renew_time=now,
            )
            try:
                self.store.create_lease(new)
            except Conflict:
                return self._set_leading(False)
            self._last_renew = now
            return self._set_leading(True)

        if lease.holder_identity != cfg.identity and not self._expired(lease):
            return self._set_leading(False)

        # we hold it, or it expired: take/renew via guarded update
        import dataclasses as _dc

        transitions = lease.lease_transitions + (
            0 if lease.holder_identity == cfg.identity else 1
        )
        new = _dc.replace(
            lease,
            holder_identity=cfg.identity,
            # the acquirer's OWN duration, not the previous holder's
            # (leaderelection.go writes LeaseDurationSeconds from config)
            lease_duration_seconds=cfg.lease_duration,
            acquire_time=lease.acquire_time if lease.holder_identity == cfg.identity else now,
            renew_time=now,
            lease_transitions=transitions,
        )
        new.meta = _dc.replace(lease.meta)
        try:
            self.store.update_lease(new, expect_rv=lease.meta.resource_version)
        except (Conflict, NotFound):
            # renew failed; give up leadership only past the renew deadline
            # (leaderelection.go:275 renewLoop's RenewDeadline timeout)
            if self._leading and now - self._last_renew < cfg.renew_deadline:
                return True
            return self._set_leading(False)
        self._last_renew = now
        return self._set_leading(True)

    def _set_leading(self, leading: bool) -> bool:
        if leading and not self._leading:
            logger.info("leaderelection: %s became leader", self.config.identity)
            if self.on_started_leading:
                self.on_started_leading()
        elif not leading and self._leading:
            logger.warning("leaderelection: %s lost leadership", self.config.identity)
            if self.on_stopped_leading:
                self.on_stopped_leading()
        self._leading = leading
        return leading

    def run_once(self) -> bool:
        """One election tick; call every retry_period (LeaderElector.Run's
        wait.JitterUntil body, unrolled for the pump-driven runtime)."""
        return self.try_acquire_or_renew()
