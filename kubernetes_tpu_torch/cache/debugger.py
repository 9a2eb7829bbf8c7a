"""Cache debugger: drift comparer + dumper, trigger on SIGUSR2
(internal/cache/debugger/{debugger,comparer,dumper}.go); an own copy of
``kubernetes_tpu/cache/debugger.py``.

The comparer diffs the scheduler's cache and queue against the store's truth
(CompareNodes/ComparePods, comparer.go); the dumper renders the cache and
waiting pods to the log (dumper.go). Both run on demand or on SIGUSR2
(debugger.go:67 ListenForSignal).
"""

from __future__ import annotations

import logging
import signal
from typing import List, Tuple

logger = logging.getLogger(__name__)


class CacheComparer:
    """cache/queue vs apiserver-truth drift detector (comparer.go:34)."""

    def __init__(self, store, cache, queue):
        self.store = store
        self.cache = cache
        self.queue = queue

    def compare_nodes(self) -> Tuple[List[str], List[str]]:
        """(missed, redundant): nodes in truth but not cache, and vice versa
        (comparer.go CompareNodes)."""
        actual = {n for n in self.store.nodes}
        cached = {n for n, ni in self.cache.nodes.items() if ni.node is not None}
        return sorted(actual - cached), sorted(cached - actual)

    def compare_pods(self) -> Tuple[List[str], List[str]]:
        """(missed, redundant) over scheduled pods in cache + pending pods in
        queue vs the store's pods (comparer.go ComparePods)."""
        actual = set(self.store.pods.keys())
        cached = set()
        for ni in self.cache.nodes.values():
            for p in ni.pods:
                cached.add(p.meta.key())
        queued = {qp.pod.meta.key() for qp in self.queue.pending_pod_infos()}
        known = cached | queued
        return sorted(actual - known), sorted(cached - actual)

    def compare(self) -> bool:
        """Log discrepancies; True when in sync (debugger.go Comparer.Compare)."""
        missed_n, redundant_n = self.compare_nodes()
        missed_p, redundant_p = self.compare_pods()
        ok = not (missed_n or redundant_n or missed_p or redundant_p)
        if not ok:
            logger.warning(
                "cache mismatch: nodes missed=%s redundant=%s; pods missed=%s redundant=%s",
                missed_n, redundant_n, missed_p, redundant_p,
            )
        else:
            logger.info("cache comparison: in sync")
        return ok


class CacheDumper:
    """Render cache + queue state for debugging (dumper.go:37 DumpAll)."""

    def __init__(self, cache, queue):
        self.cache = cache
        self.queue = queue

    def dump_all(self) -> str:
        lines = ["Dump of cached NodeInfo"]
        for name, ni in sorted(self.cache.nodes.items()):
            lines.append(
                f"Node: {name}, deleted: {ni.node is None}, pods: {len(ni.pods)}, "
                f"requested: cpu={ni.requested.milli_cpu}m mem={ni.requested.memory}, "
                f"allocatable: cpu={ni.allocatable.milli_cpu}m mem={ni.allocatable.memory}"
            )
        lines.append("Dump of scheduling queue")
        for qp in self.queue.pending_pod_infos():
            lines.append(
                f"Pod: {qp.pod.meta.key()}, attempts: {qp.attempts}, "
                f"unschedulable plugins: {sorted(qp.unschedulable_plugins)}"
            )
        text = "\n".join(lines)
        logger.info("%s", text)
        return text


class CacheDebugger:
    """Comparer + dumper behind one signal hook (debugger.go:35)."""

    def __init__(self, store, cache, queue):
        self.comparer = CacheComparer(store, cache, queue)
        self.dumper = CacheDumper(cache, queue)

    def listen_for_signal(self, signum: int = signal.SIGUSR2) -> None:
        """Install the SIGUSR2 handler (debugger.go:67); main thread only."""

        def _handle(_sig, _frame):
            self.comparer.compare()
            self.dumper.dump_all()

        signal.signal(signum, _handle)
