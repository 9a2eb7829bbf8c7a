"""The batched scheduler on the main path: sync → encode → one device call →
one device-to-host read → bind.

The device half of ``kubernetes_tpu/backend/tpu_scheduler.py``'s
``schedule_batch_cycle`` and ``_commit_inflight``, without the queue, the
framework runtime, the store or the commit plane. ``BatchScheduler`` keeps
the given NodeInfos as its cache (it binds placed pods into them) and a
``DeviceState`` mirror of them; each
``schedule`` call places pods in batches of ``caps.pods`` in the given
order. Pods with topology spread constraints or inter-pod (anti-)affinity
run in one of two topology modes (``_topo_mode_info``), the rest in mode
``off``. Each batch takes one commit path (``batch.spec_decode_eligible``):
the fused kernel (mode ``off``) or the topology scan, or the speculative
rounds. Only the features this path implements are accepted:
a pod with DRA claims, volumes or a gang label raises NotImplementedError
rather than being placed by a path that would ignore those terms.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..api.types import POD_GROUP_LABEL, Pod
from ..cache.snapshot import Snapshot
from ..framework.plugins.interpodaffinity import HOSTNAME_KEY, NsLabelsFn
from ..framework.types import NodeInfo
from ..ops.schema import Capacities
from ..utils.device import DeviceLike
from .batch import (DEFAULT_WEIGHTS, schedule_batch, spec_decode_eligible,
                    unpack_result_block)
from .device_state import DeviceState, caps_for_cluster


STAGES = ("sync", "encode", "dispatch", "read", "bind")


def unsupported_reason(pod: Pod) -> Optional[str]:
    """Why the main path cannot place ``pod`` (the later slice that will),
    or None when it can."""
    spec = pod.spec
    if spec.resource_claims:
        return "resource claims (DRA and volumes slice)"
    if spec.volumes or spec.ephemeral_claims:
        return "volumes (DRA and volumes slice)"
    if POD_GROUP_LABEL in pod.meta.labels:
        return "gang membership (gangs and slices slice)"
    return None


class BatchScheduler:
    def __init__(self, node_infos: Iterable[NodeInfo], caps: Optional[Capacities] = None,
                 device: DeviceLike = None, ns_labels_fn: Optional[NsLabelsFn] = None):
        infos = list(node_infos)
        self.caps = caps or caps_for_cluster(len(infos))
        self.state = DeviceState(self.caps, device, ns_labels_fn)
        self.device = self.state.device
        self.snapshot = Snapshot(infos)
        self.batches = 0
        self.batch_modes: List[str] = []  # topology mode of each batch, in order
        # commit path of each batch: "fused" (the kernel), "scan" or "spec"
        # (the speculative rounds), as ``spec_decode_eligible`` chose it
        self.batch_paths: List[str] = []
        # host seconds per stage of a batch, summed over batches: sync,
        # encode (pods and topology programs), dispatch (count tables
        # uploaded, static phase and the kernel or the scan enqueued), read (the
        # blocking device-to-host read, which waits for the device) and bind
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)

    def add_node(self, ni: NodeInfo) -> None:
        """Add or replace a node (its pods come with its NodeInfo)."""
        self.snapshot.set(ni)

    def remove_node(self, name: str) -> None:
        self.snapshot.remove(name)

    def schedule(self, pods: Sequence[Pod]) -> Dict[str, Optional[str]]:
        """Place ``pods`` in order, in batches; returns pod key -> node name,
        or None when no node fits."""
        for pod in pods:
            reason = unsupported_reason(pod)
            if reason is not None:
                raise NotImplementedError(f"pod {pod.key()}: {reason}")
        out: Dict[str, Optional[str]] = {}
        step = self.caps.pods
        for i in range(0, len(pods), step):
            out.update(self._schedule_batch(pods[i:i + step]))
        return out

    def _topo_mode_info(self) -> Tuple[str, Optional[int], int]:
        """(topo_mode, vd_bucket, host_key) for the sig table as the last
        ``encode_topo`` left it: "off" with no registered signature or term;
        "host" when every involved key is the hostname and every valid node
        has a hostname value of its own (a duplicate falls back, as the
        per-node fast path would count two nodes apart); else "general",
        over a domain axis of the smallest power of two >= 64 that covers
        every value id of the involved keys."""
        state = self.state
        if not state.topo_enabled:
            return ("off", None, 0)
        summary = state.sig_table.last_topo_summary
        if summary["hostname_only"]:
            host_slot = state.encoder.key_slot(HOSTNAME_KEY)
            vals = state._mirror["label_val"][state._mirror["valid"], host_slot]
            if len(np.unique(vals)) == len(vals):
                return ("host", None, host_slot)
        vd = 64
        while vd < summary["vd_needed"]:
            vd *= 2
        return ("general", vd, 0)

    def _schedule_batch(self, pods: Sequence[Pod]) -> Dict[str, Optional[str]]:
        state = self.state
        t = [time.perf_counter()]
        state.sync(self.snapshot)
        t.append(time.perf_counter())
        pb, et = state.encoder.encode_pods(pods)
        host_pb = state.encoder.last_host_pb
        # registers the batch's signatures and terms: tc is read after it
        tb = state.sig_table.encode_topo(pods)
        mode, vd, host_key = self._topo_mode_info()
        t.append(time.perf_counter())
        topo = {} if mode == "off" else dict(tc=state.tc, tb=tb, topo_mode=mode,
                                              vd_override=vd, host_key=host_key)
        spec = spec_decode_eligible(mode, self.device)
        res = schedule_batch(pb, et, state.nt, DEFAULT_WEIGHTS, device=self.device,
                             spec_decode=spec, ports_enabled=state.encoder.last_has_ports,
                             **topo)
        t.append(time.perf_counter())
        # the ONE device-to-host read of the batch
        node_idx, _first_fail = unpack_result_block(res.packed, self.caps.nodes)
        t.append(time.perf_counter())
        slot_names = state.slot_to_name()
        placed: Dict[str, Optional[str]] = {}
        for i, pod in enumerate(pods):
            slot = int(node_idx[i])
            if slot < 0:
                placed[pod.key()] = None
                continue
            name = slot_names[slot]
            bound_pod = pod.clone()
            bound_pod.spec.node_name = name
            self.snapshot.node_info_map[name].add_pod(bound_pod)  # bumps the generation
            self.snapshot.changed_names.add(name)
            placed[pod.key()] = name
        state.adopt_device(res)
        state.adopt_commits(res, host_pb, node_idx)
        t.append(time.perf_counter())
        for stage, a, b in zip(STAGES, t, t[1:]):
            self.stage_seconds[stage] += b - a
        self.batches += 1
        self.batch_modes.append(mode)
        self.batch_paths.append("spec" if spec else "fused" if mode == "off" else "scan")
        return placed
