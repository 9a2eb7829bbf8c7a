"""The port's SchedulingQueue and Cache against the JAX package's, driven
by the same seeded sequences of operations on FakeClocks that start equal.

Queue: adds, updates, deletes, batch pops, failures (unschedulable and
error), cluster events (eager and inside a coalescing window), clock
advances, backoff and unschedulable-timeout flushes; the pop order (pod
and attempts), ``pending_pods``, the cycle counters and each queued pod's
attempts must be equal after every step. The JAX queue gets the default
profile's sort key and event map; the port's queue its own default
profile's.

Cache: nodes and bound pods added, updated and removed, pods assumed,
finished, forgotten and expired; after every step ``update_snapshot`` into
one snapshot each, and the snapshot's map order (the device's slot order),
its zone-interleaved list, each node's pods, ``node_count``,
``min_pod_priority`` and ``stats`` must be equal.
"""

import numpy as np
import pytest

from _torch_cases import jax_api, torch_api

PLUGINS = ("NodeResourcesFit", "NodePorts", "InterPodAffinity", "TaintToleration",
           "NodeAffinity", "PodTopologySpread", "NodeName")


def _jax_queue(clock):
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu.queue.scheduling_queue import SchedulingQueue
    from kubernetes_tpu.scheduler.scheduler import Scheduler

    fwk = Scheduler(ClusterStore()).profiles["default-scheduler"]
    return SchedulingQueue(less_key=fwk.queue_sort_key(), now_fn=clock,
                           cluster_event_map=fwk.cluster_event_map())


def _port_queue(clock):
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.queue.scheduling_queue import SchedulingQueue
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    fwk = Scheduler(Store()).profiles["default-scheduler"]
    return SchedulingQueue(less_key=fwk.queue_sort_key(), now_fn=clock,
                           cluster_event_map=fwk.cluster_event_map())


def _events(pkg):
    if pkg == "jax":
        from kubernetes_tpu.queue import events
        from kubernetes_tpu.framework.types import (NODE, ClusterEvent,
                                                    UPDATE_NODE_LABEL, UPDATE_NODE_TAINT)
    else:
        from kubernetes_tpu_torch.queue import events
        from kubernetes_tpu_torch.framework.types import (NODE, ClusterEvent,
                                                          UPDATE_NODE_LABEL, UPDATE_NODE_TAINT)
    return [events.NODE_ADD, events.POD_ADD, events.POD_DELETE, events.UNSCHEDULABLE_TIMEOUT,
            ClusterEvent(NODE, UPDATE_NODE_LABEL, "NodeLabelChange"),
            ClusterEvent(NODE, UPDATE_NODE_TAINT, "NodeTaintChange")]


class _Side:
    def __init__(self, pkg):
        if pkg == "jax":
            from kubernetes_tpu.utils.clock import FakeClock
            self.clock, self.api = FakeClock(), jax_api()
            self.queue = _jax_queue(self.clock)
        else:
            from kubernetes_tpu_torch.utils.clock import FakeClock
            self.clock, self.api = FakeClock(), torch_api()
            self.queue = _port_queue(self.clock)
        self.events = _events(pkg)
        self.pods = {}
        self.popped = {}  # key -> (qp, cycle) popped and not yet failed

    def pod(self, name, prio, version=0):
        p = self.api.make_pod(name).req({"cpu": "100m"}).priority(prio).obj()
        p.meta.labels["v"] = str(version)
        return p

    def view(self):
        q = self.queue
        infos = sorted((qp.pod.key(), qp.attempts, tuple(sorted(qp.unschedulable_plugins)))
                       for qp in q.pending_pod_infos())
        return (dict(q.pending_pods()), q.scheduling_cycle, q.move_request_cycle, infos)


@pytest.mark.parametrize("seed", range(6))
def test_queue_sequence_matches_jax(seed):
    rng = np.random.RandomState(seed)
    sides = [_Side("jax"), _Side("port")]
    names = [f"p{i}" for i in range(40)]
    for step in range(300):
        op = rng.choice(["add", "add", "pop", "pop", "fail", "fail", "move", "window",
                         "update", "delete", "advance", "flush", "timeout"])
        args = dict(name=names[rng.randint(len(names))], prio=int(rng.choice([0, 0, 5, 100])),
                    k=int(rng.randint(1, 6)), error=bool(rng.randint(4) == 0),
                    plugins=[PLUGINS[j] for j in rng.choice(len(PLUGINS), rng.randint(0, 3),
                                                            replace=False)],
                    ev=int(rng.randint(6)), evs=rng.randint(6, size=3).tolist(),
                    dt=float(rng.choice([0.2, 0.7, 1.5, 4.0, 40.0, 400.0])), pick=rng.randint(1000))
        popped = []
        for side in sides:
            q = side.queue
            if op == "add":
                if args["name"] not in side.pods:
                    side.pods[args["name"]] = side.pod(args["name"], args["prio"])
                    q.add(side.pods[args["name"]])
            elif op == "pop":
                out = q.pop_batch(args["k"])
                for qp in out:
                    side.popped[qp.pod.key()] = (qp, q.scheduling_cycle)
                popped.append([(qp.pod.key(), qp.attempts) for qp in out])
            elif op == "fail" and side.popped:
                keys = sorted(side.popped)
                qp, cycle = side.popped.pop(keys[args["pick"] % len(keys)])
                qp.unschedulable_plugins = set(args["plugins"])
                q.add_unschedulable_if_not_present(qp, cycle, error=args["error"])
            elif op == "move":
                q.move_all_to_active_or_backoff_queue(side.events[args["ev"]])
            elif op == "window":
                with q.coalesce_moves():
                    for e in args["evs"]:
                        q.move_all_to_active_or_backoff_queue(side.events[e])
            elif op == "update" and args["name"] in side.pods:
                old = side.pods[args["name"]]
                new = side.pod(args["name"], old.spec.priority, version=step)
                side.pods[args["name"]] = new
                q.update(old, new)
            elif op == "delete" and args["name"] in side.pods:
                q.delete(side.pods.pop(args["name"]))
                side.popped.pop(f"default/{args['name']}", None)
            elif op == "advance":
                side.clock.advance(args["dt"])
            elif op == "flush":
                q.flush_backoff_completed()
            elif op == "timeout":
                q.flush_unschedulable_left_over()
        if popped:
            assert popped[0] == popped[1], step
        assert sides[0].view() == sides[1].view(), (step, op)
    assert sides[1].queue.scheduling_cycle > 50


def _cache_side(pkg):
    if pkg == "jax":
        from kubernetes_tpu.cache import Cache, Snapshot
        from kubernetes_tpu.utils.clock import FakeClock
        clock = FakeClock()
        return clock, Cache(ttl=5.0, now_fn=clock), Snapshot(), jax_api()
    from kubernetes_tpu_torch.cache.cache import Cache
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.utils.clock import FakeClock
    clock = FakeClock()
    return clock, Cache(ttl=5.0, now_fn=clock), Snapshot(), torch_api()


@pytest.mark.parametrize("seed", range(4))
def test_cache_sequence_matches_jax(seed):
    rng = np.random.RandomState(seed)
    sides = [_cache_side("jax"), _cache_side("port")]
    live_pods = [{}, {}]   # key -> pod object in the cache (bound or assumed)
    assumed = [{}, {}]
    for step in range(250):
        op = rng.choice(["node", "node", "node_update", "node_remove", "bound", "bound",
                         "assume", "assume", "finish", "forget", "remove", "advance",
                         "cleanup"])
        node = f"n{rng.randint(14)}"
        zone = f"z{rng.randint(3)}"
        cpu = str(int(rng.choice([4, 8, 16])))
        pod_name = f"p{rng.randint(60)}"
        prio = int(rng.choice([0, 3, 7]))
        pick = int(rng.randint(1000))
        dt = float(rng.choice([1.0, 3.0, 6.0]))
        for s, (clock, cache, snap, api) in enumerate(sides):
            key = f"default/{pod_name}"
            if op in ("node", "node_update"):
                n = api.make_node(node).capacity({"cpu": cpu, "pods": 20}) \
                    .label("topology.kubernetes.io/zone", zone).obj()
                (cache.add_node if op == "node" else cache.update_node)(n)
            elif op == "node_remove":
                cache.remove_node(node)
            elif op in ("bound", "assume") and key not in live_pods[s]:
                p = api.make_pod(pod_name).req({"cpu": "100m"}).priority(prio).obj()
                if op == "bound":
                    p.spec.node_name = node
                    cache.add_pod(p)
                else:
                    cache.assume_pod(p, node)
                    assumed[s][key] = p
                live_pods[s][key] = p
            elif op in ("finish", "forget") and assumed[s]:
                keys = sorted(assumed[s])
                k = keys[pick % len(keys)]
                p = assumed[s][k]
                if op == "finish":
                    cache.finish_binding(p)
                else:
                    cache.forget_pod(p)
                    del assumed[s][k]
                    live_pods[s].pop(k, None)
            elif op == "remove" and live_pods[s]:
                keys = sorted(live_pods[s])
                k = keys[pick % len(keys)]
                cache.remove_pod(live_pods[s].pop(k))
                assumed[s].pop(k, None)
            elif op == "advance":
                clock.advance(dt)
            elif op == "cleanup":
                for p in cache.cleanup():
                    live_pods[s].pop(p.key(), None)
                    assumed[s].pop(p.key(), None)
            cache.update_snapshot(snap)
        views = []
        for clock, cache, snap, _api in sides:
            views.append((
                list(snap.node_info_map),
                [ni.node.meta.name for ni in snap.list()],
                {name: sorted(p.key() for p in ni.pods) for name, ni in snap.node_info_map.items()},
                cache.node_count(), cache.min_pod_priority(), cache.stats(),
            ))
        assert views[0] == views[1], (step, op)
