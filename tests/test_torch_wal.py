"""The port's write-ahead log (``kubernetes_tpu_torch/apiserver/wal.py``)
against the JAX package's.

``WalPair`` holds a JAX ``ClusterStore`` and a port ``Store``, each with a
WAL in its own file, on one constant clock (the JAX store stamps with
``time.time``, patched to it; the port's with its ``now_fn``), and writes
every object to both: the port's as it is, the JAX store a copy rebuilt as
the JAX package's before the port's store stamps it. The same writes give
byte-equal logs and snapshots; each package restores the other's log; the
torn-tail, checksum, group-commit and compaction cases of the JAX
``tests/test_wal.py`` give equal outcomes on both; and the crash mid
workload (JAX ``test_crash_mid_workload_scheduling_resumes``) places every
pod as the JAX loop does, before and after the restore."""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import to_jax, torch_api  # noqa: E402

SEED = 24
T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _sync(monkeypatch):
    monkeypatch.setenv("KTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("KTPU_COMMIT_WORKER", "0")
    monkeypatch.delenv("KTPU_WAL_COMPACT_LINES", raising=False)


class WalPair:
    def __init__(self, tmp_path, monkeypatch, wal: bool = True):
        from kubernetes_tpu.apiserver.store import ClusterStore
        from kubernetes_tpu.apiserver.wal import attach_wal as jattach
        from kubernetes_tpu_torch.apiserver.store import Store
        from kubernetes_tpu_torch.apiserver.wal import attach_wal

        self.now = T0
        monkeypatch.setattr(time, "time", lambda: self.now)
        self.jpath, self.tpath = str(tmp_path / "jax.wal"), str(tmp_path / "port.wal")
        self.jstore, self.tstore = ClusterStore(), Store(now_fn=lambda: self.now)
        self.jwal = jattach(self.jstore, self.jpath) if wal else None
        self.twal = attach_wal(self.tstore, self.tpath) if wal else None

    def both(self, method: str, obj, *args):
        """``method(*args, obj)`` on each store; the outcomes equal."""
        jobj = to_jax(obj)
        outs = []
        for store, o in ((self.jstore, jobj), (self.tstore, obj)):
            try:
                getattr(store, method)(*args, o)
                outs.append(None)
            except Exception as err:  # noqa: BLE001 - compared
                outs.append((type(err).__name__, str(err)))
        assert outs[0] == outs[1], outs
        return outs[1]

    def call(self, method: str, *args):
        for store in (self.jstore, self.tstore):
            getattr(store, method)(*args)

    def bind(self, key: str, node: str) -> None:
        from kubernetes_tpu.api.types import Binding

        self.jstore.bind(Binding(pod_key=key, node_name=node))
        self.tstore.bind(key, node)

    def bind_batch(self, pairs) -> list:
        from kubernetes_tpu.api.types import Binding

        jout = self.jstore.bind_batch([Binding(pod_key=k, node_name=n) for k, n in pairs])
        tout = self.tstore.bind_batch(pairs)
        names = [[type(e).__name__ if e is not None else None for e in out]
                 for out in (jout, tout)]
        assert names[0] == names[1]
        return names[1]

    def logs(self):
        with open(self.jpath, "rb") as f, open(self.tpath, "rb") as g:
            return f.read(), g.read()


def _nodes(n: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cpu = str(int(rng.choice((4, 8, 16))))
        out.append(torch_api().make_node(f"n{i}").capacity(
            {"cpu": cpu, "memory": "16Gi", "pods": 20}).label("zone", f"z{i % 2}").obj())
    return out


def _pods(prefix: str, n: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    return [torch_api().make_pod(f"{prefix}{i}").req(
        {"cpu": f"{int(rng.choice((100, 500, 1000)))}m",
         "memory": f"{int(rng.choice((1, 2)))}Gi"}).obj() for i in range(n)]


def _script(pair: WalPair) -> None:
    """Every kind of write the log records: creates of built-in and generic
    kinds, RBAC objects, a CRD and its custom object, updates, deletes, a
    finalizer's two-step delete, single binds and batches with failures."""
    from kubernetes_tpu_torch.api.types import (ClusterRole, ClusterRoleBinding,
                                                CustomResource, CustomResourceDefinition,
                                                ObjectMeta, PersistentVolumeClaim, PolicyRule,
                                                Secret)

    for node in _nodes(4):
        pair.both("create_node", node)
    for pod in _pods("p", 8):
        pair.both("create_pod", pod)
    pair.now += 1.5
    pair.both("create_object", Secret(meta=ObjectMeta(name="s1")), "Secret")
    pair.both("create_object", ClusterRole(
        meta=ObjectMeta(name="reader", namespace=""),
        rules=(PolicyRule(verbs=("get",), resources=("Pod",)),)), "ClusterRole")
    pair.both("create_object", ClusterRoleBinding(
        meta=ObjectMeta(name="rb", namespace=""), role="reader", subjects=("user:a",)),
        "ClusterRoleBinding")
    pair.both("create_object", CustomResourceDefinition(
        meta=ObjectMeta(namespace=""), group="x.io", version="v1", kind="Widget",
        plural="widgets"), "CustomResourceDefinition")
    pair.both("create_object", CustomResource(
        meta=ObjectMeta(name="w1"), api_version="x.io/v1", kind="Widget",
        spec={"size": 3}), "Widget")
    pair.both("create_pvc", PersistentVolumeClaim(meta=ObjectMeta(name="claim"),
                                                  requested_bytes=1 << 30))
    pair.call("delete_pod", "default/p7")
    pair.bind("default/p0", "n1")
    assert pair.bind_batch([("default/p1", "n0"), ("default/p0", "n2"),
                            ("default/ghost", "n0"), ("default/p2", "n3")]) == [
        None, "Conflict", "NotFound", None]
    assert pair.bind_batch([("default/p3", "n2")]) == [None]
    pair.now += 2.25
    pair.both("update_object", Secret(meta=ObjectMeta(name="s1", labels={"v": "2"})), "Secret")
    pair.call("delete_object", "PersistentVolumeClaim", "default/claim")  # marked terminating
    pvc = pair.tstore.get_object("PersistentVolumeClaim", "default/claim")
    cleared = PersistentVolumeClaim(meta=ObjectMeta(name="claim"), requested_bytes=1 << 30)
    cleared.meta.finalizers = ()
    assert pvc.meta.deletion_timestamp
    pair.both("update_object", cleared, "PersistentVolumeClaim")  # the delete completes
    pair.call("delete_object", "Secret", "default/s1")
    pair.call("update_pod_nominated_node", "default/p4", "n3")


def _dump(store) -> dict:
    """Every object of a store by kind and key, in wire form (by its own
    package's codec), with the store's counters."""
    from kubernetes_tpu.api.codec import to_wire as jax_to_wire
    from kubernetes_tpu_torch.api.codec import to_wire as port_to_wire
    from kubernetes_tpu_torch.apiserver.store import Store

    to_wire = port_to_wire if isinstance(store, Store) else jax_to_wire
    out = {kind: {k: to_wire(o) for k, o in store._kind_map(kind).items()}
           for kind in store.KINDS}
    return {"objects": out, "rv": store._rv, "seq": store._event_seq}


def test_same_writes_give_byte_equal_logs_and_snapshots(tmp_path, monkeypatch):
    pair = WalPair(tmp_path, monkeypatch)
    _script(pair)
    jlog, tlog = pair.logs()
    assert jlog == tlog
    assert jlog.count(b"\n") == pair.jwal.lines_written == pair.twal.lines_written
    assert pair.twal.records_appended == pair.jwal.records_appended
    assert pair.twal.bytes_written == len(tlog)
    assert pair.tstore.KINDS == pair.jstore.KINDS
    assert pair.twal.snapshot(pair.tstore) == pair.jwal.snapshot(pair.jstore)
    with open(pair.jpath + ".snap", "rb") as f, open(pair.tpath + ".snap", "rb") as g:
        assert f.read() == g.read()
    assert os.path.getsize(pair.tpath) == os.path.getsize(pair.jpath) == 0


def test_each_package_restores_the_others_log(tmp_path, monkeypatch):
    from kubernetes_tpu.apiserver.wal import restore as jrestore
    from kubernetes_tpu_torch.apiserver.wal import restore

    pair = WalPair(tmp_path, monkeypatch)
    _script(pair)
    live = _dump(pair.tstore)
    assert live == _dump(pair.jstore)
    # the JAX log into the port's Store, the port's log into the JAX store
    tfrom_j, jfrom_t = restore(pair.jpath), jrestore(pair.tpath)
    assert _dump(tfrom_j) == _dump(jfrom_t) == live
    assert tfrom_j.get_object("Widget", "default/w1").spec == {"size": 3}
    assert tfrom_j.is_cluster_scoped("Widget") is False
    # writes after the restore, then the other way back
    from kubernetes_tpu.api.types import Binding

    tfrom_j.bind("default/p5", "n0")
    jfrom_t.bind(Binding(pod_key="default/p5", node_name="n0"))
    again_j, again_t = jrestore(pair.jpath), restore(pair.tpath)
    assert _dump(again_j) == _dump(again_t)
    assert again_t.get_pod("default/p5").spec.node_name == "n0"
    assert again_t._rv > live["rv"]
    # new writes take fresh resource versions past every restored one
    rv = again_t._rv
    again_t.create_pod(_pods("after", 1)[0])
    assert again_t.get_pod("default/after0").meta.resource_version > rv
    assert again_t.kind_version("ClusterRole") == live["objects"]["ClusterRole"][
        "reader"]["meta"]["resource_version"]


def _restored_view(store) -> dict:
    return {"nodes": sorted(store.nodes), "pods": {k: p.spec.node_name
                                                   for k, p in sorted(store.pods.items())}}


def _both_restore(pair: WalPair, edit) -> dict:
    """Apply ``edit(path)`` to both logs (bytes equal before and after),
    restore each with its package; the views equal; returns the port's."""
    from kubernetes_tpu.apiserver.wal import restore as jrestore
    from kubernetes_tpu_torch.apiserver.wal import restore

    for path in (pair.jpath, pair.tpath):
        edit(path)
    assert pair.logs()[0] == pair.logs()[1]
    jr, tr = jrestore(pair.jpath), restore(pair.tpath)
    assert _restored_view(jr) == _restored_view(tr)
    return _restored_view(tr)


def _truncate(n: int):
    def edit(path):
        with open(path, "rb+") as f:
            f.seek(-n, 2)
            f.truncate()
    return edit


def _replace_last(a: str, b: str):
    def edit(path):
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
        lines[-1] = lines[-1].replace(a, b)
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(lines)
    return edit


def test_torn_tail_and_bad_checksum(tmp_path, monkeypatch):
    pair = WalPair(tmp_path / "a", monkeypatch)
    for node in _nodes(2):
        pair.both("create_node", node)
    for pod in _pods("keep", 1) + _pods("torn", 1):
        pair.both("create_pod", pod)
    view = _both_restore(pair, _truncate(20))
    assert view == {"nodes": ["n0", "n1"], "pods": {"default/keep0": ""}}
    pair2 = WalPair(tmp_path / "b", monkeypatch)
    pair2.both("create_node", _nodes(1)[0])
    for pod in _pods("good", 1) + _pods("flipped", 1):
        pair2.both("create_pod", pod)
    view = _both_restore(pair2, _replace_last("flipped", "flipqed"))
    assert view["pods"] == {"default/good0": ""}


def test_replay_stops_at_garbage(tmp_path, monkeypatch):
    from kubernetes_tpu.apiserver.wal import replay as jreplay
    from kubernetes_tpu_torch.apiserver.wal import replay

    pair = WalPair(tmp_path, monkeypatch)
    pair.both("create_node", _nodes(1)[0])
    pair.both("create_pod", _pods("p", 1)[0])
    for path in (pair.jpath, pair.tpath):
        with open(path, "a", encoding="utf-8") as f:
            f.write('deadbeef {"not": "valid for that crc"}\n')
    assert list(replay(pair.tpath)) == list(jreplay(pair.jpath))
    assert [r["event"] for r in replay(pair.tpath)] == ["ADDED", "ADDED"]


@pytest.mark.parametrize("edit", ["torn", "checksum"])
def test_a_broken_batch_line_drops_the_whole_batch(tmp_path, monkeypatch, edit):
    pair = WalPair(tmp_path, monkeypatch)
    for node in _nodes(2):
        pair.both("create_node", node)
    for pod in _pods("b", 3):
        pair.both("create_pod", pod)
    assert pair.bind_batch([(f"default/b{i}", "n0") for i in range(3)]) == [None] * 3
    view = _both_restore(pair, _truncate(10) if edit == "torn"
                         else _replace_last("Running", "Runnjng"))
    assert view["pods"] == {f"default/b{i}": "" for i in range(3)}


def test_group_commit_one_line_per_batch(tmp_path, monkeypatch):
    from kubernetes_tpu_torch.apiserver.wal import replay

    pair = WalPair(tmp_path, monkeypatch)
    for node in _nodes(2):
        pair.both("create_node", node)
    for pod in _pods("g", 5):
        pair.both("create_pod", pod)
    lines, recs = pair.twal.lines_written, pair.twal.records_appended
    pair.bind_batch([(f"default/g{i}", f"n{i % 2}") for i in range(5)])
    assert (pair.twal.lines_written, pair.twal.records_appended) == (lines + 1, recs + 5)
    assert (pair.jwal.lines_written, pair.jwal.records_appended) == (lines + 1, recs + 5)
    tail = list(replay(pair.tpath))[-5:]
    assert [(r["event"], r["key"]) for r in tail] == [
        ("MODIFIED", f"default/g{i}") for i in range(5)]
    with open(pair.tpath, encoding="utf-8") as f:
        assert '"batch"' in f.readlines()[-1]
    assert pair.bind_batch([("default/g0", "n0")]) == ["Conflict"]
    assert pair.twal.lines_written == lines + 1  # a failed bind writes nothing
    assert pair.logs()[0] == pair.logs()[1]


def test_per_pod_and_batched_logs_restore_the_same_store(tmp_path, monkeypatch):
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore

    monkeypatch.setattr(time, "time", lambda: T0)

    def build(batched: bool, path: str):
        store = Store(now_fn=lambda: T0)
        attach_wal(store, path)
        for node in _nodes(2):
            store.create_node(node)
        for pod in _pods("p", 6):
            store.create_pod(pod)
        store.bind("default/p0", "n0")
        store.bind("default/p1", "n1")
        rest = [(f"default/p{i}", f"n{i % 2}") for i in range(2, 6)]
        if batched:
            assert store.bind_batch(rest) == [None] * 4
        else:
            for key, node in rest:
                store.bind(key, node)

    build(False, str(tmp_path / "a.wal"))
    build(True, str(tmp_path / "b.wal"))
    assert _dump(restore(str(tmp_path / "a.wal"))) == _dump(restore(str(tmp_path / "b.wal")))


def test_compaction_threshold_and_restore(tmp_path, monkeypatch):
    from kubernetes_tpu_torch.apiserver.wal import restore

    monkeypatch.setenv("KTPU_WAL_COMPACT_LINES", "10")
    pair = WalPair(tmp_path, monkeypatch)
    assert pair.twal.compact_lines == pair.jwal.compact_lines == 10
    for node in _nodes(2):
        pair.both("create_node", node)
    assert pair.twal.maybe_compact(pair.tstore) is pair.jwal.maybe_compact(pair.jstore) is False
    for pod in _pods("p", 10):
        pair.both("create_pod", pod)
    assert pair.twal.maybe_compact(pair.tstore) is pair.jwal.maybe_compact(pair.jstore) is True
    assert os.path.getsize(pair.tpath) == 0 and os.path.exists(pair.tpath + ".snap")
    assert pair.twal.maybe_compact(pair.tstore) is False
    pair.both("create_pod", _pods("tail", 1)[0])
    assert pair.twal.maybe_compact(pair.tstore) is False
    with open(pair.jpath + ".snap", "rb") as f, open(pair.tpath + ".snap", "rb") as g:
        assert f.read() == g.read()
    assert pair.logs()[0] == pair.logs()[1]
    restored = restore(pair.tpath)  # a crash here: snapshot and tail
    assert set(restored.pods) == set(pair.tstore.pods)
    assert set(restored.nodes) == set(pair.tstore.nodes)


def test_compaction_off_by_default(tmp_path, monkeypatch):
    pair = WalPair(tmp_path, monkeypatch)
    for pod in _pods("p", 30):
        pair.both("create_pod", pod)
    assert pair.twal.compact_lines == 0
    assert pair.twal.maybe_compact(pair.tstore) is False
    assert not os.path.exists(pair.tpath + ".snap")


def test_housekeeping_drives_compaction(tmp_path, monkeypatch):
    """The loop's 1 s sweep calls ``maybe_compact``: a live workload past
    the threshold compacts, and the restore holds every bind."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.apiserver.wal import attach_wal, restore
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    monkeypatch.setenv("KTPU_WAL_COMPACT_LINES", "16")
    clock = FakeClock()
    store = Store(now_fn=clock)
    path = str(tmp_path / "store.wal")
    wal = attach_wal(store, path)
    for node in _nodes(4):
        store.create_node(node)
    sched = TPUScheduler(store, device="cpu", now_fn=clock, batch_size=8, batch_deadline_ms=0)
    for pod in _pods("w", 24):
        store.create_pod(pod)
    sched.run_until_settled()
    assert wal.lines_written - wal._lines_at_compact >= 16
    sched._periodic_housekeeping(clock() + 1.5)
    assert wal._lines_at_compact == wal.lines_written
    assert os.path.exists(path + ".snap")
    restored = restore(path)
    bound = {k: p.spec.node_name for k, p in store.pods.items() if p.spec.node_name}
    assert len(bound) == 24
    assert {k: p.spec.node_name for k, p in restored.pods.items()} == bound


def test_crash_mid_workload_equals_jax(tmp_path, monkeypatch):
    """JAX ``test_crash_mid_workload_scheduling_resumes`` on both packages:
    6 nodes, 12 pods bound, 8 more created but not scheduled, the process
    gone; the restored stores hold every bind, and fresh loops place the
    rest, then one more pod, as the JAX loop does."""
    from kubernetes_tpu.apiserver.wal import restore as jrestore
    from kubernetes_tpu.backend.tpu_scheduler import TPUScheduler as JTPUScheduler
    from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
    from kubernetes_tpu_torch.apiserver.wal import restore
    from kubernetes_tpu_torch.backend.tpu_scheduler import TPUScheduler
    from kubernetes_tpu_torch.utils.clock import FakeClock

    pair = WalPair(tmp_path, monkeypatch)

    def loops(jstore, tstore):
        return (JTPUScheduler(jstore, now_fn=JFakeClock(), batch_size=16, batch_deadline_ms=0),
                TPUScheduler(tstore, device="cpu", now_fn=FakeClock(), batch_size=16,
                             batch_deadline_ms=0))

    def placed(store):
        return {k: p.spec.node_name for k, p in sorted(store.pods.items())}

    for node in _nodes(6):
        pair.both("create_node", node)
    jsched, tsched = loops(pair.jstore, pair.tstore)
    for pod in _pods("pre", 12):
        pair.both("create_pod", pod)
    jsched.run_until_settled()
    tsched.run_until_settled()
    before = placed(pair.tstore)
    assert before == placed(pair.jstore) and all(before.values())
    for pod in _pods("mid", 8, seed=SEED + 1):
        pair.both("create_pod", pod)
    assert pair.logs()[0] == pair.logs()[1]
    del jsched, tsched  # the crash
    jr, tr = jrestore(pair.jpath), restore(pair.tpath)
    for key, node in before.items():
        assert tr.get_pod(key).spec.node_name == node
    jsched, tsched = loops(jr, tr)
    jsched.run_until_settled()
    tsched.run_until_settled()
    assert placed(tr) == placed(jr) and all(placed(tr).values())
    post = _pods("post", 1)[0]
    jr.create_pod(to_jax(post))
    tr.create_pod(post)
    jsched.run_until_settled()
    tsched.run_until_settled()
    assert placed(tr) == placed(jr) and tr.get_pod("default/post0").spec.node_name
