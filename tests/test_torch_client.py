"""The port's client runtime (``kubernetes_tpu_torch/client/``) and its
store's watch surface (``apiserver/store.py``: the journal, ``Watch``,
``list_objects``, ``watch``, ``Expired``, the Lease accessors) against the
JAX package's, on the CPU.

The same script runs against each package's objects: the workqueue's order,
dedup and exponential backoff on a stepped clock; ``parallelize_until``'s
chunks; DeltaFIFO's compaction and relist reconciliation; the journal's
events (kind, type, key, resource version, sequence) for one write sequence
of every journaled write (nodes, pods, binds, nominations, generic kinds,
storage kinds, claim allocate / release, PV bind, PDBs, PriorityClasses,
namespaces, leases); the reflector's relist when its watch expired; an
informer's indexers and handler fan-out (synthetic adds for a late
handler); leader election over Lease writes; a reflector thread watching
while another thread writes (the store's one lock). Every output must be
equal."""

import pytest


class Kit:
    """One package's client, store and object constructors."""

    def __init__(self, pkg: str):
        if pkg == "jax":
            from kubernetes_tpu import client
            from kubernetes_tpu.api import types
            from kubernetes_tpu.api.wrappers import make_node, make_pod
            from kubernetes_tpu.apiserver import store
            from kubernetes_tpu.client import delta_fifo, leaderelection, workqueue

            self.new_store = store.ClusterStore
        else:
            from kubernetes_tpu_torch import client
            from kubernetes_tpu_torch.api import types
            from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
            from kubernetes_tpu_torch.apiserver import store
            from kubernetes_tpu_torch.client import delta_fifo, leaderelection, workqueue

            self.new_store = store.Store
        self.pkg, self.client, self.types, self.store_mod = pkg, client, types, store
        self.make_node, self.make_pod = make_node, make_pod
        self.delta_fifo, self.leaderelection, self.workqueue = (delta_fifo, leaderelection,
                                                                 workqueue)

    def bind(self, store, key, node):
        if self.pkg == "jax":
            store.bind(self.types.Binding(pod_key=key, node_name=node))
        else:
            store.bind(key, node)

    def bind_batch(self, store, pairs):
        if self.pkg == "jax":
            return store.bind_batch([self.types.Binding(pod_key=k, node_name=n)
                                     for k, n in pairs])
        return store.bind_batch(pairs)


KITS = {pkg: Kit(pkg) for pkg in ("jax", "port")}


def both(fn):
    """``fn(kit)`` for the JAX kit and the port's; asserts them equal and
    returns the port's."""
    want, got = fn(KITS["jax"]), fn(KITS["port"])
    assert got == want
    return got


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------- workqueue


def test_workqueue_order_dedup_and_backoff():
    def script(k):
        clock = Clock()
        q = k.workqueue.RateLimitingQueue(base_delay=0.5, max_delay=4.0, now_fn=clock)
        out = []
        for item in ("a", "b", "a", "c"):
            q.add(item)
        out.append(len(q))
        a = q.get()
        q.add(a)  # re-added while processing: queued again on done()
        out += [a, len(q)]
        q.done(a)
        out.append([q.get() for _ in range(4)])
        for item in ("b", "c", "a"):
            q.done(item)
        for _ in range(3):  # three failures of "x": 0.5, 1, 2 s
            q.add_rate_limited("x")
        out.append((q.num_requeues("x"), q.get()))
        for dt in (0.4, 0.2, 0.5, 1.0, 5.0):
            clock.t += dt
            out.append(q.get())
        q.forget("x")
        out.append(q.num_requeues("x"))
        for _ in range(6):
            q.add_rate_limited("y")  # capped at max_delay
        clock.t += 3.9
        q.flush_waiting()
        out.append(len(q))
        clock.t += 0.2
        out.append(q.get())
        q.shutdown()
        q.add("z")
        out.append(len(q))
        return out

    got = both(script)
    assert got[:3] == [3, "a", 2] and got[4] == (3, None)


def test_parallelize_until_covers_every_piece():
    def script(k):
        wq = k.workqueue
        sizes = [(n, p, wq.chunk_size_for(n, p)) for n in (1, 7, 100, 1000) for p in (1, 4, 16)]
        seen = []
        wq.parallelize_until(4, 103, seen.append)
        wq.parallelize_until(1, 5, seen.append)
        wq.parallelize_until(3, 0, seen.append)
        return sizes, sorted(seen)

    sizes, seen = both(script)
    assert seen == sorted(list(range(103)) + list(range(5)))


# ---------------------------------------------------------------- DeltaFIFO


def test_delta_fifo_compaction_and_replace():
    def script(k):
        df = k.delta_fifo
        known = {"k1": "old1", "k9": "old9"}
        fifo = df.DeltaFIFO(lambda o: o.split(":")[0], known_objects=lambda: list(known))
        fifo.add("k1:a")
        fifo.update("k1:b")
        fifo.delete("k1:c")
        fifo.delete("k1:d")  # two Deleted in a row collapse into the last
        fifo.add("k2:a")
        out = [fifo.populated, len(fifo)]
        fifo.replace(["k2:b", "k3:a"])  # k1 (queued) and k9 (known) get tombstones
        out.append(len(fifo))
        while True:
            deltas = fifo.pop()
            if deltas is None:
                break
            out.append([(d.type, d.object) for d in deltas])
        out.append(fifo.has_synced())
        fresh = df.DeltaFIFO(lambda o: o, known_objects=lambda: [])
        out.append(fresh.has_synced())
        fresh.replace(["x", "y"])
        out.append((fresh.initial_population_count, fresh.has_synced()))
        fresh.pop()
        fresh.pop()
        out.append(fresh.has_synced())
        return out

    got = both(script)
    assert got[3] == [("Added", "k1:a"), ("Updated", "k1:b"), ("Deleted", "k1:d")]


# ---------------------------------------------------------------- the journal


def _write_all(k, store) -> None:
    """One write of every journaled kind, in a fixed order."""
    t = k.types
    store.create_namespace(t.Namespace(meta=t.ObjectMeta(name="team", namespace="",
                                                         labels={"tier": "a"})))
    for i in range(3):
        store.create_node(k.make_node(f"n{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": 10}).label("zone", f"z{i % 2}").obj())
    for i in range(4):
        store.create_pod(k.make_pod(f"p{i}").req({"cpu": "100m"}).obj())
    k.bind(store, "default/p0", "n0")
    k.bind_batch(store, [("default/p1", "n1"), ("default/nope", "n1"), ("default/p2", "n2")])
    store.update_pod_nominated_node("default/p3", "n2")
    store.create_object("ResourceClass", t.ResourceClass(
        meta=t.ObjectMeta(name="gpu", namespace=""), driver_name="gpu"))
    store.create_object("ResourceClaim", t.ResourceClaim(
        meta=t.ObjectMeta(name="c1"), resource_class_name="gpu"))
    store.allocate_claim("default/c1", "n0", "default/p0")
    store.release_claim("default/c1", "default/p0")
    store.create_pv(t.PersistentVolume(meta=t.ObjectMeta(name="pv1", namespace=""),
                                       capacity_bytes=1 << 30))
    store.create_pvc(t.PersistentVolumeClaim(meta=t.ObjectMeta(name="pvc1"),
                                             requested_bytes=1 << 30))
    store.bind_pv("pv1", "default/pvc1")
    store.create_storage_class(t.StorageClass(meta=t.ObjectMeta(name="sc", namespace="")))
    store.create_csinode(t.CSINode(meta=t.ObjectMeta(name="n0", namespace=""),
                                   drivers={"ebs": 39}))
    store.create_pdb(t.PodDisruptionBudget(meta=t.ObjectMeta(name="pdb")))
    store.create_priority_class(t.PriorityClass(meta=t.ObjectMeta(name="high", namespace=""),
                                                value=100))
    store.create_object("Secret", t.Secret(meta=t.ObjectMeta(name="s")))
    store.create_object("ResourceClaimTemplate", t.ResourceClaimTemplate(
        meta=t.ObjectMeta(name="tmpl"), resource_class_name="gpu"))
    store.update_object("ResourceClass", t.ResourceClass(
        meta=t.ObjectMeta(name="gpu", namespace=""), driver_name="gpu2"))
    lease = t.Lease(meta=t.ObjectMeta(name="l", namespace="kube-system"), holder_identity="a")
    store.create_lease(lease)
    store.delete_object("ResourceClaim", "default/c1")
    store.delete_pod("default/p2")
    store.delete_node("n2")


KINDS = ("Namespace", "Node", "Pod", "ResourceClass", "ResourceClaim", "PersistentVolume",
         "PersistentVolumeClaim", "StorageClass", "CSINode", "PodDisruptionBudget",
         "PriorityClass", "Secret", "ResourceClaimTemplate", "Lease")


def _key(obj):
    return obj.meta.key() if obj.meta.namespace else obj.meta.name


def test_journal_events_match_jax():
    """Every kind's watch from 0 replays the journal: the same events, in
    the same order, with the same sequence numbers and resource versions;
    a live watch sees later writes; a stopped one none."""

    def script(k):
        store = k.new_store()
        live = store.watch("Pod", since=0)
        _write_all(k, store)
        out = {}
        for kind in KINDS:
            w = store.watch(kind, since=0)
            out[kind] = [(ev.seq, ev.type, _key(ev.object), ev.object.meta.resource_version,
                          None if ev.old is None else ev.old.meta.resource_version)
                         for ev in w.drain()]
            w.stop()
        out["live"] = [(ev.seq, ev.type) for ev in live.drain()]
        live.stop()
        store.create_pod(k.make_pod("late").obj())
        out["stopped"] = live.next()
        objects, rv = store.list_objects("Pod")
        out["list"] = (sorted(_key(o) for o in objects), rv)
        out["snapshot"] = sorted(store.snapshot_map("Node"))
        return out

    got = both(script)
    assert [e[1] for e in got["Pod"]].count("DELETED") == 1 and got["stopped"] is None
    assert got["live"] == [(e[0], e[1]) for e in got["Pod"]]
    assert all(got[kind] for kind in KINDS)


def test_reflector_relists_when_its_watch_expired():
    def script(k):
        store = k.new_store()
        store._journal_capacity = 4
        for i in range(3):
            store.create_node(k.make_node(f"n{i}").obj())
        fifo = k.delta_fifo.DeltaFIFO(lambda o: o.meta.name)
        refl = k.client.Reflector(store, "Node", fifo)
        refl.list_and_establish_watch()
        out = [refl.last_sync_rv]
        refl.stop()  # the watch stops: the writes below are missed
        for i in range(3, 9):
            store.create_node(k.make_node(f"n{i}").obj())
        store.delete_node("n0")
        with pytest.raises(k.store_mod.Expired):
            store.watch("Node", since=refl.last_sync_rv)
        refl.relist()
        out.append(refl.last_sync_rv)
        store.create_node(k.make_node("n9").obj())
        out.append(refl.step())
        out.append(refl.last_sync_rv)
        popped = []
        while True:
            deltas = fifo.pop()
            if deltas is None:
                break
            popped.append([(d.type, d.object if isinstance(d.object, str) else d.object.meta.name)
                           for d in deltas])
        out.append(popped)
        return out

    got = both(script)
    assert got[2] == 1
    # n0 was listed by the first LIST and is gone at the relist: no Deleted
    # for it (nothing consumed the FIFO's keys), every live node Replaced
    assert ["n9"] == [d[0][1] for d in got[4] if d[0][0] == "Added"]


def test_informer_indexers_and_fan_out():
    def script(k):
        store = k.new_store()
        for i in range(3):
            store.create_node(k.make_node(f"n{i}").obj())
        factory = k.client.SharedInformerFactory(store)
        pods = factory.informer_for("Pod", indexers={
            "node": lambda p: [p.spec.node_name] if p.spec.node_name else []})
        nodes = factory.informer_for("Node")
        assert factory.informer_for("Pod") is pods
        events = []
        pods.add_event_handler(lambda ev, old, new: events.append(
            ("pods", ev, _key(old) if old else None, _key(new) if new else None)))
        synced = factory.wait_for_cache_sync()
        for i in range(4):
            store.create_pod(k.make_pod(f"p{i}").obj())
        k.bind(store, "default/p0", "n0")
        k.bind(store, "default/p1", "n0")
        k.bind(store, "default/p2", "n1")
        store.delete_pod("default/p1")
        handled = factory.pump()
        late = []
        nodes.add_event_handler(lambda ev, old, new: late.append((ev, _key(new))))
        return (synced, handled, events, sorted(late),
                sorted(_key(p) for p in pods.indexer.by_index("node", "n0")),
                sorted(_key(p) for p in pods.indexer.by_index("node", "n1")),
                pods.indexer.by_index("node", "n2"), sorted(_key(o) for o in pods.list()),
                pods.has_synced(), nodes.get("n1").meta.name)

    got = both(script)
    assert got[0] and got[4] == ["default/p0"] and got[5] == ["default/p2"]
    assert got[3] == [("add", "n0"), ("add", "n1"), ("add", "n2")]


def test_leader_election_over_lease_writes():
    def script(k):
        store = k.new_store()
        clock = Clock()
        le = k.leaderelection
        out = []
        transitions = []

        def elector(ident):
            return le.LeaderElector(
                store, le.LeaderElectionConfig(identity=ident, lease_duration=15.0,
                                               renew_deadline=10.0),
                on_started_leading=lambda: transitions.append((ident, "start")),
                on_stopped_leading=lambda: transitions.append((ident, "stop")),
                now_fn=clock)

        a, b = elector("a"), elector("b")
        for dt in (0.0, 2.0, 2.0):
            clock.t += dt
            out.append((a.run_once(), b.run_once()))
        clock.t += 20.0  # a stops renewing: its lease expires
        out.append((b.run_once(), a.is_leader()))
        out.append(a.run_once())
        lease = store.get_lease("kube-system/kube-scheduler")
        out.append((lease.holder_identity, lease.lease_transitions, lease.acquire_time,
                    lease.renew_time, lease.meta.resource_version))
        stale = k.types.Lease(meta=k.types.ObjectMeta(name="kube-scheduler",
                                                       namespace="kube-system"))
        with pytest.raises(k.store_mod.Conflict):
            store.update_lease(stale, expect_rv=lease.meta.resource_version - 1)
        return out, transitions

    out, transitions = both(script)
    assert out[0] == (True, False) and out[3] == (True, True)
    assert ("b", "start") in transitions and ("a", "stop") in transitions


def test_reflector_thread_sees_every_write():
    """A reflector's own thread (``Reflector.run``) watching while another
    thread writes: the informer's cache ends equal to the store, each pod
    at its last resource version."""
    import time

    def script(k):
        store = k.new_store()
        inf = k.client.SharedInformerFactory(store).informer_for("Pod")
        inf.start()
        thread = inf.reflector.run(poll_interval=0.01)
        for i in range(200):
            store.create_pod(k.make_pod(f"p{i}").obj())
            if i % 3 == 0:
                store.delete_pod(f"default/p{i // 2}")
        deadline = time.monotonic() + 30.0
        while inf.reflector.last_sync_rv < store._event_seq and time.monotonic() < deadline:
            time.sleep(0.01)
        inf.reflector.stop()
        thread.join(timeout=5.0)
        while True:
            deltas = inf.fifo.pop()
            if deltas is None:
                break
            inf._handle_deltas(deltas)
        return ({_key(p): p.meta.resource_version for p in inf.list()},
                {k_: p.meta.resource_version for k_, p in store.pods.items()},
                thread.is_alive())

    cache, truth, alive = both(script)
    assert cache == truth and len(truth) == 133 and not alive
