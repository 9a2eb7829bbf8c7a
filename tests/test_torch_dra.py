"""The port's DRA claim path on the CPU against the JAX package, exactly:

* ``claim_feasibility_mask`` over seeded attribute tables and selector rows
  (all six ops, absent cells, kind mismatches, -1 padding, int32 extremes);
* the device-attribute table of ``DeviceState`` (key slots, string ids and
  their free list, growth past 8 columns, release on node removal) against
  the JAX ``DeviceState``;
* ``build_dra_mask`` and ``ClaimMaskBuilder`` with the allocated-node
  restriction;
* masked batches (a volume screen and a claim mask) on every commit path:
  the fused kernel's plain version, the topology scan and the speculative
  rounds, against the JAX program; the first-fail order 1-4, 9, 10;
* ``BatchScheduler`` on a small SchedulingDRA against the JAX batched path
  (placements and claim allocations), and the shared-claim retry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (SnapshotShim, TOPO_MODES, claim_allocations, f32_bits, jax_api,
                          jax_encoded, jax_masked_loop, numpy_fields, run_masked_workload_both,
                          topo_case_args, torch_api, u32)
from kubernetes_tpu.api import dra as jdra
from kubernetes_tpu.backend import batch as jbatch
from kubernetes_tpu.backend import claim_mask as jclaim
from kubernetes_tpu.backend.device_state import DeviceState as JDeviceState
from kubernetes_tpu.ops.schema import Capacities as JCaps
from kubernetes_tpu_torch import interop
from kubernetes_tpu_torch.api import dra as tdra
from kubernetes_tpu_torch.backend import batch as tbatch
from kubernetes_tpu_torch.backend import claim_mask as tclaim
from kubernetes_tpu_torch.backend.device_state import DeviceState as TDeviceState
from kubernetes_tpu_torch.ops.schema import Capacities as TCaps

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1

# ------------------------------------------------------------ the claim mask


def _tables(seed: int, n: int = 70, a: int = 12, p: int = 24, s: int = 8):
    """Seeded attribute cells and selector rows. Values cluster on a few
    numbers and the int32 extremes, so every op meets equal, smaller and
    larger operands; string ids share one small range with the ints."""
    rng = np.random.RandomState(seed)
    pool = np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, 2, 3, 8, 16, I32_MAX - 1, I32_MAX])
    attr_kind = rng.choice([0, 1, 2], size=(n, a), p=[0.3, 0.4, 0.3]).astype(np.int32)
    attr_val = np.where(attr_kind == 2, rng.randint(1, 4, size=(n, a)),
                        rng.choice(pool, size=(n, a)))
    attr_val = np.where(attr_kind == 0, 0, attr_val).astype(np.int32)
    sel_key = rng.randint(0, a, size=(p, s)).astype(np.int32)
    sel_op = rng.choice([-1, 0, 1, 2, 3, 4, 5], size=(p, s)).astype(np.int32)
    sel_op[:, 3:] = -1                                   # rows padded after 3 selectors
    sel_op[0] = -1                                       # a pod with no selector
    sel_kind = rng.choice([1, 2], size=(p, s)).astype(np.int32)
    sel_val = np.where(sel_kind == 2, rng.randint(1, 4, size=(p, s)),
                       rng.choice(pool, size=(p, s))).astype(np.int32)
    return sel_key, sel_op, sel_kind, sel_val, attr_kind, attr_val


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_claim_mask_matches_jax(seed):
    arrays = _tables(seed)
    want = np.asarray(jbatch.claim_feasibility_mask(*(jnp.asarray(x) for x in arrays)))
    got = tbatch.claim_feasibility_mask(*(torch.from_numpy(x) for x in arrays))
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].all()              # no selector: every node
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("op", ["==", "!=", ">=", ">", "<=", "<"])
def test_claim_mask_each_op_matches_host_predicate(op):
    """One selector per pod over every (kind, value) cell: the mask equals
    api/dra.py's DeviceSelector.matches, on both packages."""
    cells = [None, True, I32_MIN, -1, 0, 8, I32_MAX, 2 ** 40, "v5", "8"]
    operands = [I32_MIN, 0, 8, I32_MAX, "v5", "v4"]
    nodes = [{"k": c} if c is not None else {} for c in cells]
    ds = TDeviceState(TCaps(nodes=16, pods=8), device="cpu")
    sels = [tdra.parse_selector("k", f"{op}{v}") for v in operands]
    entries = [(i, [sel], []) for i, sel in enumerate(sels)]
    from kubernetes_tpu_torch.cache.snapshot import Snapshot

    infos = [torch_api().NodeInfo(torch_api().make_node(f"n{i}").device_attrs(a).obj())
             for i, a in enumerate(nodes)]
    ds.sync(Snapshot(infos))
    mask = tclaim.build_dra_mask(ds, entries, 8).numpy()
    for i, sel in enumerate(sels):
        for j, attrs in enumerate(nodes):
            slot = ds.encoder.node_slots[f"n{j}"]
            assert mask[i, slot] == sel.matches(attrs), (op, operands[i], cells[j])
            assert jdra.parse_selector("k", f"{op}{operands[i]}").matches(attrs) == mask[i, slot]
    assert mask[len(sels):].all()  # padding pods


# --------------------------------------------------------- the attribute table


def _attr_nodes(api, spec):
    return [api.NodeInfo(api.make_node(name).capacity({"cpu": "8", "memory": "16Gi", "pods": 20})
                         .device_attrs(attrs).obj()) for name, attrs in spec]


def _assert_same_table(jds, tds):
    assert tds.attr_slots == jds.attr_slots
    assert tds.attr_val_ids == jds.attr_val_ids
    assert tds._attr_val_free == jds._attr_val_free
    assert tds._attr_val_next == jds._attr_val_next
    assert tds._attr_val_refs == jds._attr_val_refs
    np.testing.assert_array_equal(tds.attr_kind.numpy(), np.asarray(jds.attr_kind))
    np.testing.assert_array_equal(tds.attr_val.numpy(), np.asarray(jds.attr_val))


def test_attr_table_matches_jax_through_churn():
    from kubernetes_tpu_torch.cache.snapshot import Snapshot

    rng = np.random.RandomState(5)
    spec = {f"n{i}": {"gen": ["v4", "v5", "v6"][i % 3], "cores": int(rng.choice([8, 16])),
                      "big": 2 ** 40 if i % 4 == 0 else -2 ** 40, "flag": True,
                      f"model-{i % 5}": f"m{i}"} for i in range(12)}
    jds = JDeviceState(JCaps(nodes=32, pods=8))
    tds = TDeviceState(TCaps(nodes=32, pods=8), device="cpu")
    jinfos = {n: ni for n, ni in zip(spec, _attr_nodes(jax_api(), spec.items()))}
    snap = Snapshot(_attr_nodes(torch_api(), spec.items()))

    def sync():
        jds.sync(SnapshotShim(jinfos.values()))
        tds.sync(snap)
        _assert_same_table(jds, tds)

    sync()
    assert len(tds.attr_slots) == 9 and tds._attr_cols == 16   # grown past 8 columns
    assert tds.attr_kind.numpy()[tds.encoder.node_slots["n0"], tds.attr_slots["flag"]] == 0
    assert tds.attr_val.numpy()[tds.encoder.node_slots["n0"], tds.attr_slots["big"]] == I32_MAX
    # selector operands register keys and values between syncs
    for ds in (jds, tds):
        ds.attr_slot("never-published")
        ds.attr_value_id("operand-only")
    _assert_same_table(jds, tds)
    # churn: remove four nodes (values lose their last publisher), change
    # one node's map, then add nodes with fresh values and keys
    for name in ("n1", "n2", "n3", "n5"):
        del jinfos[name]
        snap.remove(name)
    changed = {"gen": "v9", "extra": "x"}
    jinfos["n4"] = _attr_nodes(jax_api(), [("n4", changed)])[0]
    snap.set(_attr_nodes(torch_api(), [("n4", changed)])[0])
    sync()
    assert tds._attr_val_free  # released ids wait for reuse
    fresh = [(f"new{i}", {"gen": f"g{i}", f"key-{i}": i, "model-1": "m1"}) for i in range(10)]
    for ni in _attr_nodes(jax_api(), fresh):
        jinfos[ni.node.meta.name] = ni
    for ni in _attr_nodes(torch_api(), fresh):
        snap.set(ni)
    sync()
    assert tds._attr_cols == 32
    # every node gone: the table is empty again, every string id freed
    for name in list(jinfos):
        del jinfos[name]
        snap.remove(name)
    sync()
    assert not tds.attr_kind.numpy().any() and not tds._attr_val_refs


# ------------------------------------------------- build_dra_mask and the builder


def _dra_cluster(api, n=24):
    spec = [(f"node-{i}", {"tpu.dev/gen": ["v5", "v5", "v4", "v5"][i % 4],
                           "tpu.dev/cores": [4, 8, 16][i % 3]}) for i in range(n)]
    return _attr_nodes(api, spec)


def _both_states(n=24):
    from kubernetes_tpu_torch.cache.snapshot import Snapshot

    jds = JDeviceState(JCaps(nodes=32, pods=16))
    jds.sync(SnapshotShim(_dra_cluster(jax_api(), n)))
    tds = TDeviceState(TCaps(nodes=32, pods=16), device="cpu")
    tds.sync(Snapshot(_dra_cluster(torch_api(), n)))
    return jds, tds


def test_build_dra_mask_with_allocated_restriction_matches_jax():
    jds, tds = _both_states()
    raw = [(0, {"tpu.dev/gen": "v5"}, []),
           (2, {"tpu.dev/cores": ">=8", "tpu.dev/gen": "v5"}, ["node-5"]),   # allowed there
           (3, {"tpu.dev/cores": ">=8"}, ["node-0"]),                         # fails there
           (4, {"tpu.dev/cores": "<16"}, ["node-1", "node-7"]),               # two nodes: none
           (5, {}, ["gone-node"]),                                           # unknown node
           (6, {"tpu.dev/pcie": "!=1", "tpu.dev/gen": "v6"}, []),            # new key, value
           (9, {"tpu.dev/gen": 5}, [])]                                      # kind mismatch
    j_entries = [(p, jdra.parse_selectors(s), a) for p, s, a in raw]
    t_entries = [(p, tdra.parse_selectors(s), a) for p, s, a in raw]
    want = np.asarray(jclaim.build_dra_mask(jds, j_entries, 16))
    got = tclaim.build_dra_mask(tds, t_entries, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_same_table(jds, tds)   # the operands registered the same slots and ids
    slot = tds.encoder.node_slots
    assert got[2].sum() == 1 and got[2, slot["node-5"]]
    assert not got[3].any() and not got[4].any() and not got[5].any() and not got[9].any()
    assert got[1].all() and got[7].all()    # pods without entries
    assert tclaim.build_dra_mask(tds, [], 16) is None


def _claim_stores():
    from kubernetes_tpu.api.types import ObjectMeta as JMeta
    from kubernetes_tpu.api.types import ResourceClaim as JClaim
    from kubernetes_tpu.api.types import ResourceClass as JClass
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.api.types import ObjectMeta as TMeta
    from kubernetes_tpu_torch.api.types import ResourceClaim as TClaim
    from kubernetes_tpu_torch.api.types import ResourceClass as TClass
    from kubernetes_tpu_torch.apiserver.store import Store

    stores = []
    for store, meta, klass, claim in ((ClusterStore(), JMeta, JClass, JClaim),
                                      (Store(), TMeta, TClass, TClaim)):
        store.create_object("ResourceClass", klass(meta=meta(name="tpu", namespace=""),
                                                   selectors={"tpu.dev/gen": "v5"}))
        store.create_object("ResourceClaim", claim(meta=meta(name="c-free"),
                                                   resource_class_name="tpu",
                                                   selectors={"tpu.dev/cores": ">=8"}))
        store.create_object("ResourceClaim", claim(meta=meta(name="c-pinned"),
                                                   resource_class_name="tpu",
                                                   allocated_node="node-5",
                                                   reserved_for=("default/x",)))
        store.create_object("ResourceClaim", claim(meta=meta(name="c-noclass"),
                                                   resource_class_name="missing"))
        stores.append(store)
    return stores


def _claim_pods(api):
    return [api.make_pod("a").resource_claim("dev", claim_name="c-free").obj(),
            api.make_pod("b").obj(),
            api.make_pod("c").resource_claim("dev", claim_name="c-pinned").obj(),
            api.make_pod("d").resource_claim("dev", claim_name="c-free")
            .resource_claim("pin", claim_name="c-pinned").obj(),
            api.make_pod("e").resource_claim("dev", claim_name="c-missing").obj(),
            api.make_pod("f").resource_claim("dev", claim_name="c-noclass").obj()]


def test_claim_mask_builder_matches_jax():
    jstore, tstore = _claim_stores()
    jds, tds = _both_states()
    jpods, tpods = _claim_pods(jax_api()), _claim_pods(torch_api())
    jb, tb = jclaim.ClaimMaskBuilder(jstore), tclaim.ClaimMaskBuilder(tstore)
    assert [jb.batchable(p) for p in jpods] == [tb.batchable(p) for p in tpods] \
        == [True, True, True, True, False, False]
    qps = [type("QP", (), {"pod": p})() for p in jpods]
    want = np.asarray(jb.build(qps, jds, 16))
    got = tb.build(tpods, tds, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2].sum() == 1  # pinned to node-5, a v5 node with 16 cores
    assert tb.build([torch_api().make_pod("z").obj()], tds, 16) is None


def test_claim_prefilter_and_filter_match_jax_plugin():
    """The port's claim resolution and exact Filter against the JAX
    DynamicResources plugin's PreFilter and Filter on every (pod, node)."""
    from kubernetes_tpu.framework.interface import CycleState
    from kubernetes_tpu.framework.plugins.dynamicresources import DynamicResources
    from kubernetes_tpu_torch.framework.plugins import dynamicresources as tdr

    jstore, tstore = _claim_stores()
    plugin = DynamicResources(client=jstore)
    jnodes, tnodes = _dra_cluster(jax_api()), _dra_cluster(torch_api())
    verdicts = set()
    for jpod, tpod in zip(_claim_pods(jax_api()), _claim_pods(torch_api())):
        state = CycleState()
        _, st = plugin.pre_filter(state, jpod)
        claims, reason = tdr.pre_filter(tstore, tpod)
        assert reason == (None if st.is_success() else st.reasons[0])
        if reason is not None:
            verdicts.add(reason)
            continue
        for jni, tni in zip(jnodes, tnodes):
            jst = plugin.filter(state, jpod, jni)
            want = None if jst.is_success() else jst.reasons[0]
            assert tdr.filter_node(claims, tni.node) == want
            verdicts.add(want)
    assert len(verdicts) == 4, verdicts  # passes, cannot allocate, two unresolvable


# --------------------------------------------------------------- masked batches


def _masks(seed, p, n, n_real):
    """A seeded volume screen and claim mask: about a sixth of the cells
    fail each, and pod 2 has every node masked by claims."""
    rng = np.random.RandomState(seed)
    extra = rng.uniform(size=(p, n)) > 1 / 6
    dra = rng.uniform(size=(p, n)) > 1 / 6
    dra[2] = False
    return extra, dra


def _case(case, seed):
    if case == "off":
        jds, pods, pb, et = jax_encoded(40, 48, seed, nominate="node-3", node_name="node-9")
        return jds, pb, et, jds.sig_table.encode_topo(pods), dict(topo_mode="off")
    jds, pb, et, tb, kw = topo_case_args(case, seed)
    return jds, pb, et, tb, kw


FIELDS = ("node_idx", "any_feasible", "fit_ok", "ports_ok", "spread_ok", "ipa_ok",
          "first_fail", "final_requested", "final_nonzero", "final_class_req", "packed")


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("case", ["off", "host", "general-bucket"])
def test_masked_batch_matches_jax(case, spec):
    """Both masks on the fused kernel's plain version (``off``), the
    topology scan and the rounds, against the JAX scan or rounds with the
    same masks: every field, the packed bytes and the best_score bits."""
    jds, pb, et, tb, kw = _case(case, 3)
    p, n = np.asarray(pb.valid).shape[0], np.asarray(jds.nt.valid).shape[0]
    extra, dra = _masks(7, p, n, 40)
    jres = jbatch.schedule_batch(pb, et, jds.nt, jds.tc, tb, jax.random.PRNGKey(0),
                                 topo_enabled=case != "off", spec_decode=spec,
                                 extra_mask=jnp.asarray(extra), dra_mask=jnp.asarray(dra), **kw)
    args = (interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
            interop.expr_table_from_numpy(numpy_fields(et), "cpu"),
            interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"))
    topo = {} if case == "off" else dict(
        tc=interop.topo_counts_from_numpy(numpy_fields(jds.tc), "cpu"),
        tb=interop.topo_batch_from_numpy(numpy_fields(tb), "cpu"))
    tres = tbatch.schedule_batch(*args, device="cpu", spec_decode=spec,
                                 extra_mask=torch.from_numpy(extra),
                                 dra_mask=torch.from_numpy(dra), **topo, **kw)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), err_msg=name)
    np.testing.assert_array_equal(u32(tres.final_ports), np.asarray(jres.final_ports))
    np.testing.assert_array_equal(f32_bits(tres.best_score), f32_bits(jres.best_score))
    assert tres.packed.numpy().tobytes() == np.asarray(jres.packed).tobytes()
    ff = tres.first_fail.numpy()
    assert {9, 10}.issubset(set(np.unique(ff).tolist()))
    assert int(tres.node_idx[2]) == -1 and (ff[2][np.asarray(jds.nt.valid)] != 0).all()
    assert (tres.node_idx.numpy() >= 0).sum() > 10


def test_first_fail_order_with_both_masks():
    """A cell failing a static filter and both masks reports the static id;
    both masks alone report 9; the claim mask alone 10."""
    jds, _pods, pb, et = jax_encoded(40, 48, 1)
    nt, tpb, tet = (interop.node_tensors_from_numpy(numpy_fields(jds.nt), "cpu"),
                    interop.pod_batch_from_numpy(numpy_fields(pb), "cpu"),
                    interop.expr_table_from_numpy(numpy_fields(et), "cpu"))
    base = tbatch.static_phase(tpb, tet, nt)[2].numpy()
    taint = np.argwhere(base == 3)[0]
    clean = np.argwhere((base == 0) & nt.valid.numpy()[None, :] & tpb.valid.numpy()[:, None])
    both, only_dra = clean[0], clean[1]
    extra = np.ones(base.shape, bool)
    dra = np.ones(base.shape, bool)
    for cell in (taint, both):
        extra[tuple(cell)] = dra[tuple(cell)] = False
    dra[tuple(only_dra)] = False
    got = tbatch.static_phase(tpb, tet, nt, torch.from_numpy(extra), torch.from_numpy(dra))
    want = jbatch.schedule_batch(pb, et, jds.nt, jds.tc, jds.sig_table.encode_topo(_pods),
                                 jax.random.PRNGKey(0), topo_enabled=False,
                                 extra_mask=jnp.asarray(extra), dra_mask=jnp.asarray(dra))
    ff = got[2].numpy()
    assert ff[tuple(taint)] == 3 and ff[tuple(both)] == 9 and ff[tuple(only_dra)] == 10
    static = ff != 0   # the static ids decide a cell before any dynamic filter
    np.testing.assert_array_equal(np.asarray(want.first_fail)[static], ff[static])
    assert not got[1].numpy()[tuple(only_dra)]


# --------------------------------------------------------------- BatchScheduler


def test_batch_scheduler_dra_matches_jax():
    placed_j, jstore, turned_j, placed_t, tstore, sched = run_masked_workload_both(
        "scheduling_dra")
    assert placed_t == placed_j
    assert claim_allocations(tstore) == claim_allocations(jstore)
    assert all(placed_t.values()) and not turned_j
    assert not sched.retry and not sched.fallback
    gen = {ni.node.meta.name: ni.node.status.device_attributes["tpu.dev/gen"]
           for ni in sched.snapshot.node_info_map.values()}
    assert {gen[v] for v in placed_t.values()} == {"v5"}
    assert set(sched.batch_paths) == {"fused"}


def _shared_claim_setup(api, store, meta, klass, claim, n=12):
    store.create_object("ResourceClass", klass(meta=meta(name="tpu", namespace=""),
                                               selectors={"tpu.dev/gen": "v5"}))
    store.create_object("ResourceClaim", claim(meta=meta(name="shared"), resource_class_name="tpu",
                                               selectors={"tpu.dev/cores": ">=8"}))
    pods = [api.make_pod(f"p{i}").req({"cpu": "100m"}).resource_claim("dev", claim_name="shared")
            .obj() for i in range(3)]
    pods.insert(1, api.make_pod("plain").req({"cpu": "100m"}).obj())
    return _dra_cluster(api, n), pods


def test_shared_claim_retry_matches_jax():
    """Pods sharing one unallocated claim in one batch: the first Reserve
    allocates it, a pod the device placed elsewhere fails Reserve and lands
    in ``retry``; resubmitted, it is pinned to the allocated node. The JAX
    batched path turns the same pods away and places them the same."""
    from kubernetes_tpu.api.types import ObjectMeta as JMeta
    from kubernetes_tpu.api.types import ResourceClaim as JClaim
    from kubernetes_tpu.api.types import ResourceClass as JClass
    from kubernetes_tpu.apiserver.store import ClusterStore
    from kubernetes_tpu_torch.api.types import ObjectMeta as TMeta
    from kubernetes_tpu_torch.api.types import ResourceClaim as TClaim
    from kubernetes_tpu_torch.api.types import ResourceClass as TClass
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler

    jstore, tstore = ClusterStore(), Store()
    jnodes, jpods = _shared_claim_setup(jax_api(), jstore, JMeta, JClass, JClaim)
    tnodes, tpods = _shared_claim_setup(torch_api(), tstore, TMeta, TClass, TClaim)
    jinfos = {ni.node.meta.name: ni for ni in jnodes}
    jds = JDeviceState(JCaps(nodes=32, pods=8))
    fn = jbatch.build_schedule_batch_fn()
    sched = BatchScheduler(tnodes, caps=TCaps(nodes=32, pods=8), device="cpu", client=tstore)

    turned_j = {}
    placed_j = jax_masked_loop(jds, fn, jinfos, jstore, jpods, 8, turned_j)
    placed_t = sched.schedule(tpods)
    assert placed_t == placed_j
    assert set(sched.retry) == {k for k, v in turned_j.items() if v == "retry"}
    assert sched.retry and not sched.fallback
    assert all("cannot allocate all claims" in r for r in sched.retry.values())
    first = placed_t["default/p0"]
    # the rows of the turned-away pods go back to the snapshot's content
    sched.state.sync(sched.snapshot)
    fresh = TDeviceState(TCaps(nodes=32, pods=8), device="cpu")
    fresh.sync(type(sched.snapshot)(sched.snapshot.node_info_map.values()))
    np.testing.assert_array_equal(sched.state.nt.requested.numpy(), fresh.nt.requested.numpy())
    # resubmitted: every pod lands on the claim's node
    again_t = sched.schedule([p for p in tpods if p.key() in sched.retry])
    again_j = jax_masked_loop(jds, fn, jinfos, jstore,
                              [p for p in jpods if p.key() in turned_j], 8, turned_j)
    assert again_t == again_j and set(again_t.values()) == {first}
    assert not sched.retry and not turned_j
    assert claim_allocations(tstore) == claim_allocations(jstore)
    alloc = tstore.get_object("ResourceClaim", "default/shared")
    assert alloc.allocated_node == first
    assert set(alloc.reserved_for) == {"default/p0", "default/p1", "default/p2"}


def test_unresolvable_claims_raise():
    from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler

    _jstore, tstore = _claim_stores()
    sched = BatchScheduler(_dra_cluster(torch_api()), caps=TCaps(nodes=32, pods=16),
                           device="cpu", client=tstore)
    pods = _claim_pods(torch_api())
    for pod in pods[4:]:   # a missing claim, a claim of a missing class
        with pytest.raises(NotImplementedError):
            sched.schedule([pod])
    eph = torch_api().make_pod("eph").obj()
    eph.spec.ephemeral_claims = ("scratch",)
    with pytest.raises(NotImplementedError):
        sched.schedule([eph])
    assert sched.batches == 0
    placed = sched.schedule(pods[:3])
    assert placed["default/c"] == "node-5" and all(placed.values())
    assert tstore.get_object("ResourceClaim", "default/c-pinned").reserved_for == (
        "default/x", "default/c")
