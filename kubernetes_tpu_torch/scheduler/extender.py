"""Scheduler extenders, the out-of-process extension protocol: an own copy
of ``kubernetes_tpu/scheduler/extender.py`` (pkg/scheduler/extender.go:
HTTPExtender :42, Filter :247, Prioritize :317, Bind :359,
ProcessPreemption :135; the wire types of staging/src/k8s.io/
kube-scheduler/extender/v1/types.go).

``Extender`` is the contract (framework/extender.go:27), ``CallableExtender``
an in-process one built from plain functions (the config's ``instance``),
``HTTPExtender`` the JSON-over-HTTP one, one POST per verb per pod over
``urllib`` with its timeout, and ``build_extenders`` turns a config's
entries into them (scheduler.go:409). Where the loop calls them:
``scheduler/scheduler.py`` (Filter and Prioritize on the sequential path,
Bind), ``backend/tpu_scheduler.py:_bind_stage`` (Bind on both paths),
``framework/preemption.py:Evaluator._call_extenders`` (ProcessPreemption).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api.types import Node, Pod


class ExtenderError(Exception):
    pass


def pod_to_wire(pod: Pod) -> dict:
    return {
        "metadata": {"name": pod.meta.name, "namespace": pod.meta.namespace,
                     "labels": dict(pod.meta.labels)},
        "spec": {"priority": pod.spec.priority, "schedulerName": pod.spec.scheduler_name},
    }


class Extender:
    """The framework.Extender contract (framework/extender.go:27)."""

    def name(self) -> str:
        raise NotImplementedError

    def is_ignorable(self) -> bool:
        return False

    def filter(self, pod: Pod, nodes: List[Node]) -> Tuple[List[Node], Dict[str, str], Dict[str, str]]:
        """Returns (feasible nodes, failed node -> reason, failed-and-
        unresolvable node -> reason).  Unresolvable nodes are excluded from
        preemption (schedule_one.go:573-585 gives them precedence)."""
        raise NotImplementedError

    def prioritize(self, pod: Pod, nodes: List[Node]) -> Dict[str, int]:
        """Returns node name -> raw score (to be multiplied by weight)."""
        raise NotImplementedError

    def weight(self) -> int:
        return 1

    def is_binder(self) -> bool:
        return False

    def bind(self, pod: Pod, node_name: str) -> None:
        raise NotImplementedError

    def is_interested(self, pod: Pod) -> bool:
        return True

    def supports_preemption(self) -> bool:
        return False

    def process_preemption(
        self, pod: Pod, victims_by_node: Dict[str, List[Pod]], node_infos
    ) -> Dict[str, List[Pod]]:
        return victims_by_node


class CallableExtender(Extender):
    """In-process extender built from plain callables (the test seam the
    reference covers with fake extenders in extender_test.go)."""

    def __init__(
        self,
        name: str = "callable-extender",
        filter_fn: Optional[Callable[[Pod, List[Node]], Tuple[List[Node], Dict[str, str]]]] = None,
        prioritize_fn: Optional[Callable[[Pod, List[Node]], Dict[str, int]]] = None,
        bind_fn: Optional[Callable[[Pod, str], None]] = None,
        weight: int = 1,
        ignorable: bool = False,
        interested_fn: Optional[Callable[[Pod], bool]] = None,
    ):
        self._name = name
        self._filter = filter_fn
        self._prioritize = prioritize_fn
        self._bind = bind_fn
        self._weight = weight
        self._ignorable = ignorable
        self._interested = interested_fn

    def name(self) -> str:
        return self._name

    def is_ignorable(self) -> bool:
        return self._ignorable

    def weight(self) -> int:
        return self._weight

    def is_binder(self) -> bool:
        return self._bind is not None

    def is_interested(self, pod: Pod) -> bool:
        return self._interested(pod) if self._interested else True

    def filter(self, pod: Pod, nodes: List[Node]) -> Tuple[List[Node], Dict[str, str], Dict[str, str]]:
        if self._filter is None:
            return nodes, {}, {}
        out = self._filter(pod, nodes)
        if len(out) == 2:  # simple callables may omit the unresolvable map
            return out[0], out[1], {}
        return out

    def prioritize(self, pod: Pod, nodes: List[Node]) -> Dict[str, int]:
        if self._prioritize is None:
            return {n.meta.name: 0 for n in nodes}
        return self._prioritize(pod, nodes)

    def bind(self, pod: Pod, node_name: str) -> None:
        if self._bind is None:
            raise ExtenderError(f"extender {self._name} is not a binder")
        self._bind(pod, node_name)


class HTTPExtender(Extender):
    """The reference's JSON-over-HTTP extender (extender.go:42): one POST
    per verb per pod to ``<url_prefix>/<verb>``, each bounded by
    ``timeout`` seconds."""

    def __init__(
        self,
        url_prefix: str,
        filter_verb: str = "",
        prioritize_verb: str = "",
        bind_verb: str = "",
        preempt_verb: str = "",
        weight: int = 1,
        node_cache_capable: bool = False,
        ignorable: bool = False,
        timeout: float = 5.0,
    ):
        self.url_prefix = url_prefix.rstrip("/")
        self.filter_verb = filter_verb
        self.prioritize_verb = prioritize_verb
        self.bind_verb = bind_verb
        self.preempt_verb = preempt_verb
        self._weight = weight
        self.node_cache_capable = node_cache_capable
        self._ignorable = ignorable
        self.timeout = timeout

    def name(self) -> str:
        return self.url_prefix

    def is_ignorable(self) -> bool:
        return self._ignorable

    def weight(self) -> int:
        return self._weight

    def is_binder(self) -> bool:
        return bool(self.bind_verb)

    def _post(self, verb: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.url_prefix}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def filter(self, pod: Pod, nodes: List[Node]) -> Tuple[List[Node], Dict[str, str], Dict[str, str]]:
        if not self.filter_verb:
            return nodes, {}, {}
        args = {"Pod": pod_to_wire(pod)}
        if self.node_cache_capable:
            args["NodeNames"] = [n.meta.name for n in nodes]
        else:
            args["Nodes"] = {"Items": [{"metadata": {"name": n.meta.name}} for n in nodes]}
        result = self._post(self.filter_verb, args)
        if result.get("Error"):
            raise ExtenderError(result["Error"])
        unresolvable = dict(result.get("FailedAndUnresolvableNodes") or {})
        # unresolvable takes precedence over plain failed (schedule_one.go:573)
        failed = {
            k: v for k, v in (result.get("FailedNodes") or {}).items() if k not in unresolvable
        }
        if self.node_cache_capable and result.get("NodeNames") is not None:
            keep = set(result["NodeNames"])
        else:
            keep = {item["metadata"]["name"] for item in (result.get("Nodes") or {}).get("Items", [])}
        return [n for n in nodes if n.meta.name in keep], failed, unresolvable

    def prioritize(self, pod: Pod, nodes: List[Node]) -> Dict[str, int]:
        if not self.prioritize_verb:
            return {n.meta.name: 0 for n in nodes}
        args = {"Pod": pod_to_wire(pod), "NodeNames": [n.meta.name for n in nodes]}
        result = self._post(self.prioritize_verb, args)
        return {hp["Host"]: int(hp["Score"]) for hp in result or []}

    def bind(self, pod: Pod, node_name: str) -> None:
        result = self._post(self.bind_verb, {
            "PodName": pod.meta.name, "PodNamespace": pod.meta.namespace, "Node": node_name,
        })
        if result and result.get("Error"):
            raise ExtenderError(result["Error"])

    def supports_preemption(self) -> bool:
        return bool(self.preempt_verb)

    def process_preemption(self, pod: Pod, victims_by_node, node_infos):
        """(extender.go:135) POST ExtenderPreemptionArgs; returns the trimmed
        NodeNameToMetaVictims mapped back onto our Pod objects."""
        args = {
            "Pod": pod_to_wire(pod),
            "NodeNameToMetaVictims": {
                node: {"Pods": [{"UID": p.meta.uid or p.key()} for p in victims]}
                for node, victims in victims_by_node.items()
            },
        }
        result = self._post(self.preempt_verb, args)
        out = {}
        by_uid = {
            (p.meta.uid or p.key()): p
            for victims in victims_by_node.values()
            for p in victims
        }
        for node, meta in (result.get("NodeNameToMetaVictims") or {}).items():
            pods = [by_uid[v["UID"]] for v in meta.get("Pods", []) if v.get("UID") in by_uid]
            out[node] = pods
        return out


def build_extenders(configs: Sequence) -> List[Extender]:
    """scheduler.go:409 buildExtenders: config entries → Extender objects."""
    out: List[Extender] = []
    for c in configs:
        if getattr(c, "instance", None) is not None:
            out.append(c.instance)
            continue
        out.append(
            HTTPExtender(
                url_prefix=c.url_prefix,
                filter_verb=c.filter_verb,
                prioritize_verb=c.prioritize_verb,
                bind_verb=c.bind_verb,
                preempt_verb=c.preempt_verb,
                weight=c.weight,
                node_cache_capable=c.node_cache_capable,
                ignorable=c.ignorable,
            )
        )
    return out
