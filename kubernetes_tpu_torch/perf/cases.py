"""The scheduler_perf test cases as op lists: an own copy of the JAX
package's ``kubernetes_tpu/perf/workloads.py`` (the transcription of
test/integration/scheduler_perf/config/performance-config.yaml), which
``perf/harness.py:run_workload`` runs and ``python -m
kubernetes_tpu_torch.perf`` runs by name from ``TEST_CASES``: the same 25
factories, names, defaults and dicts.

The port's ``perf/workloads.py`` is not this module's counterpart: it holds
the same workloads as API objects (``Workload``) and the functions
``chip_smoke.py`` and the parity tests call.

Sizes are parameters, so the tests run the small variants and the card the
5000Nodes ones (performance-config.yaml:1-100 SchedulingBasic, :283-464
TopologySpreading / Preemption / Unschedulable)."""

from __future__ import annotations


def scheduling_basic(nodes=5000, init_pods=1000, measured=1000) -> dict:
    return {
        "name": f"SchedulingBasic/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init"},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "measured"},
        ],
    }


def topology_spreading(nodes=5000, init_pods=5000, measured=2000) -> dict:
    return {
        "name": f"TopologySpreading/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init"},
            {"opcode": "barrier"},
            {
                "opcode": "measurePods",
                "count": measured,
                "prefix": "spread",
                "spread_topology_key": "topology.kubernetes.io/zone",
            },
        ],
    }


def scheduling_pod_anti_affinity(nodes=5000, init_pods=1000, measured=1000) -> dict:
    """performance-config.yaml:23-50 SchedulingPodAntiAffinity: every pod
    carries color=green and a required anti-affinity to color=green on the
    hostname topology — each node accepts at most one such pod."""
    pod = {
        "req": {"cpu": "100m", "memory": "500Mi"},
        "pod_affinity_key": "kubernetes.io/hostname",
        "pod_affinity_labels": {"color": "green"},
        "anti": True,
    }
    return {
        "name": f"SchedulingPodAntiAffinity/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "anti", **pod},
        ],
    }


def scheduling_pod_affinity(nodes=5000, init_pods=5000, measured=1000) -> dict:
    """performance-config.yaml:168-198 SchedulingPodAffinity: all nodes share
    one zone; pods carry color=blue and required affinity to color=blue on
    the zone key (co-location in the single shared domain)."""
    pod = {
        "req": {"cpu": "100m", "memory": "500Mi"},
        "pod_affinity_key": "topology.kubernetes.io/zone",
        "pod_affinity_labels": {"color": "blue"},
    }
    return {
        "name": f"SchedulingPodAffinity/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes,
             "labels": {"topology.kubernetes.io/zone": "zone1",
                        "kubernetes.io/hostname": "node-{i}"}},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "aff", **pod},
        ],
    }


def unschedulable(nodes=5000, init_pods=200, measured=2000) -> dict:
    """performance-config.yaml:437-463 Unschedulable: init pods request
    impossible cpu and clog the queue (skipWaitToCompletion — no barrier);
    the MEASURED pods are default-shaped, so the row reports schedulable
    throughput while the failure path churns alongside."""
    return {
        "name": f"Unschedulable/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {
                "opcode": "createPods",
                "count": init_pods,
                "prefix": "unsched",
                "req": {"cpu": "512", "memory": "4Ti"},
            },
            {"opcode": "measurePods", "count": measured, "prefix": "measured"},
        ],
    }


def scheduling_secrets(nodes=5000, init_pods=5000, measured=1000) -> dict:
    """performance-config.yaml:52-72 SchedulingSecrets: every pod mounts a
    secret volume (pod-with-secret-volume.yaml). Secret volumes need no
    binding, so the row isolates the cost of the volume-bearing codec path
    staying on the batched pipeline."""
    pod = {"req": {"cpu": "100m", "memory": "500Mi"}, "secret_volume": "secret"}
    return {
        "name": f"SchedulingSecrets/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "sec", **pod},
        ],
    }


def scheduling_intree_pvs(nodes=5000, init_pods=5000, measured=1000) -> dict:
    """performance-config.yaml:74-97 SchedulingInTreePVs: each pod claims a
    pre-bound in-tree (EBS) PV/PVC pair (pv-aws.yaml + pvc.yaml). PVC pods
    take the host sequential path here (VolumeBinding is PreBind-heavy,
    SURVEY §7 hard-part 6) — this row is the honest price of that fallback."""
    pod = {"req": {"cpu": "100m", "memory": "500Mi"}, "pvc": {"volume_type": "ebs"}}
    return {
        "name": f"SchedulingInTreePVs/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "pv", **pod},
        ],
    }


def scheduling_csi_pvs(nodes=5000, init_pods=5000, measured=1000) -> dict:
    """performance-config.yaml:136-166 SchedulingCSIPVs: nodes carry a
    CSINode attachable-volume limit (39, the EBS default) and pods claim
    pre-bound CSI PVs — exercises the CSI volume-limits filter on the host
    path."""
    pod = {"req": {"cpu": "100m", "memory": "500Mi"}, "pvc": {"volume_type": ""}}
    return {
        "name": f"SchedulingCSIPVs/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10,
             "csi_driver": "ebs.csi.aws.com", "csi_count": 39},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "csi", **pod},
        ],
    }


def scheduling_preferred_pod_affinity(nodes=5000, init_pods=5000, measured=1000) -> dict:
    """performance-config.yaml:199-226 SchedulingPreferredPodAffinity: pods
    carry color=red and a weight-1 PREFERRED affinity to color=red on the
    hostname topology (scoring load, no filter restriction)."""
    pod = {
        "req": {"cpu": "100m", "memory": "500Mi"},
        "preferred_affinity_labels": {"color": "red"},
    }
    return {
        "name": f"SchedulingPreferredPodAffinity/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "pref", **pod},
        ],
    }


def scheduling_preferred_pod_anti_affinity(nodes=5000, init_pods=5000,
                                           measured=1000) -> dict:
    """performance-config.yaml:228-255: the anti flavor (spread by score)."""
    pod = {
        "req": {"cpu": "100m", "memory": "500Mi"},
        "preferred_affinity_labels": {"color": "yellow"},
        "anti": True,
    }
    return {
        "name": f"SchedulingPreferredPodAntiAffinity/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "panti", **pod},
        ],
    }


def mixed_scheduling_base_pod(nodes=5000, init_pods=2000, measured=1000) -> dict:
    """performance-config.yaml:337-380 MixedSchedulingBasePod: one shared
    zone; init waves of base, required (anti-)affinity, and preferred
    (anti-)affinity pods, then measured base pods against that mixed
    standing population."""
    node_labels = {"topology.kubernetes.io/zone": "zone1",
                   "kubernetes.io/hostname": "node-{i}"}
    base = {"req": {"cpu": "100m", "memory": "500Mi"}}
    return {
        "name": f"MixedSchedulingBasePod/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "labels": node_labels},
            {"opcode": "createPods", "count": init_pods, "prefix": "base", **base},
            # required affinity rides the ZONE key (pod-with-pod-affinity.yaml
            # topologyKey: topology.kubernetes.io/zone; every node is zone1) —
            # on the hostname key the wave deadlocks once the first blue
            # node fills (only blue-hosting nodes are feasible, exactly as
            # in the reference semantics)
            {"opcode": "createPods", "count": init_pods, "prefix": "aff", **base,
             "pod_affinity_key": "topology.kubernetes.io/zone",
             "pod_affinity_labels": {"color": "blue"}},
            {"opcode": "createPods", "count": init_pods, "prefix": "anti", **base,
             "pod_affinity_key": "kubernetes.io/hostname",
             "pod_affinity_labels": {"color": "green"}, "anti": True},
            {"opcode": "createPods", "count": init_pods, "prefix": "paff", **base,
             "preferred_affinity_labels": {"color": "red"}},
            {"opcode": "createPods", "count": init_pods, "prefix": "panti", **base,
             "preferred_affinity_labels": {"color": "yellow"}, "anti": True},
            # 5 waves x init_pods with affinity/anti/preferred shapes take
            # well past the default 300s barrier on the CPU fallback
            {"opcode": "barrier", "timeout_s": 1800.0},
            {"opcode": "measurePods", "count": measured, "prefix": "measured", **base},
        ],
    }


def scheduling_dra(nodes=5000, init_pods=1000, measured=1000) -> dict:
    """SchedulingDRA — the BASELINE stretch-config shape (full default
    plugin set + DRA structured-parameter claims): nodes publish device
    slices (NodeStatus.device_attributes, varied so only the v5 subset is
    feasible), pods carry claim templates the resourceclaim controller
    materializes, and the DynamicResources plugin gates placement. On the
    tpu backend the claims ride the batched claim-feasibility mask
    (backend/claim_mask.py) — the row measures that path staying off the
    sequential fallback."""
    pod = {
        "req": {"cpu": "100m", "memory": "500Mi"},
        "claims": [{"name": "accel", "template": "tpu-claim",
                    "class": "tpu.example.com",
                    "class_selectors": {"tpu.dev/gen": "v5"},
                    "selectors": {"tpu.dev/cores": ">=8"}}],
    }
    return {
        "name": f"SchedulingDRA/{nodes}Nodes",
        "ops": [
            # list-valued attributes vary per node (i % len): 3 of 4 nodes
            # publish gen v5, all publish >=8 cores — claims filter to 75%
            {"opcode": "createNodes", "count": nodes, "zones": 10,
             "device_attributes": {"tpu.dev/cores": [8, 16],
                                   "tpu.dev/gen": ["v5", "v5", "v4", "v5"]}},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "dra", **pod},
        ],
    }


def scheduling_gangs(nodes=5000, init_gangs=4, measured_gangs=8) -> dict:
    """SchedulingGangs — the gang-scheduling acceptance workload: mixed
    gang sizes 8 and 32 (the multi-host TPU job shapes), each member
    carrying the pod-group label plus a required anti-affinity to its own
    group on the hostname key (one worker per host). The Runner creates the
    PodGroup objects (minMember = gang size) and the Coscheduling plugin
    releases each gang atomically at Permit; on the tpu backend the gangs
    ride the batched path end to end (gang kernel verdicts + whole-gang
    commit), measured by SchedulingThroughput plus the
    scheduler_gang_wait_duration_seconds / scheduler_gangs_rejected_total
    family."""
    base = {"req": {"cpu": "100m", "memory": "500Mi"}}
    return {
        "name": f"SchedulingGangs/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_gangs * 8,
             "prefix": "initg8", "gang_size": 8, **base},
            {"opcode": "createPods", "count": init_gangs * 32,
             "prefix": "initg32", "gang_size": 32, **base},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured_gangs * 8,
             "prefix": "g8", "gang_size": 8, **base},
            {"opcode": "measurePods", "count": measured_gangs * 32,
             "prefix": "g32", "gang_size": 32, **base},
        ],
    }


def scheduling_slices(nodes=512, slots=64, init_gangs=2, measured_small=4,
                      measured_medium=2, measured_large=1) -> dict:
    """SchedulingSlices — torus-aware slice packing (the multi-host TPU
    placement contract): every node is one TPU host (CHIPS_PER_NODE=4
    chips) publishing its (superpod, slot) coordinate labels, and slice
    gangs (PodGroups whose pods carry the ``ktpu.dev/slice`` marker) must
    land on CONTIGUOUS slot runs inside ONE superpod, all-or-nothing —
    ops/slice.py in-jit on the tpu/wire backends, the SlicePacking plugin
    on the oracle. Mixed job shapes: 8-chip (2 hosts), 32-chip (8 hosts)
    and 256-chip (64 hosts; needs ``slots`` >= 64, pass measured_large=0
    on smaller tori) gangs. Each worker FILLS its host (req ~= capacity),
    so hosts are slice-exclusive and fragmentation is measurable from the
    free-host map. Judged by SchedulingThroughput plus the SliceStats
    DataItem: per-superpod fragmentation, ContiguityViolations == 0,
    FallbackScheduled == 0, and the scheduler_slice_* metric family."""
    host = {"req": {"cpu": "3500m", "memory": "12Gi"},
            "slice": True, "gang_anti_affinity": False}
    ops = [
        {"opcode": "createNodes", "count": nodes,
         "capacity": {"cpu": "4", "memory": "16Gi", "pods": 8},
         "tpu_topology": {"slots": slots}},
        {"opcode": "createPods", "count": init_gangs * 2, "prefix": "init8c",
         "gang_size": 2, **host},
        {"opcode": "barrier"},
        {"opcode": "measurePods", "count": measured_small * 2,
         "prefix": "s8c", "gang_size": 2, **host},
        {"opcode": "measurePods", "count": measured_medium * 8,
         "prefix": "s32c", "gang_size": 8, **host},
    ]
    if measured_large:
        ops.append({"opcode": "measurePods", "count": measured_large * 64,
                    "prefix": "s256c", "gang_size": 64, **host})
    ops.append({"opcode": "collectSliceStats"})
    return {"name": f"SchedulingSlices/{nodes}Nodes", "ops": ops}


def preemption_basic(nodes=500, init_pods=2000, measured=500) -> dict:
    return {
        "name": f"PreemptionBasic/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes,
             "capacity": {"cpu": "4", "memory": "16Gi", "pods": 32}},
            {"opcode": "createPods", "count": init_pods, "prefix": "victim",
             "req": {"cpu": "900m", "memory": "2Gi"}, "priority": 1},
            # a few preemptors BEFORE the barrier: the failure-path programs
            # (preempt screen, carry variants) jit-compile during init, not
            # inside the measured phase (the relay's persistent compile
            # cache does not survive across processes)
            {"opcode": "createPods", "count": 8, "prefix": "warm",
             "req": {"cpu": "2", "memory": "4Gi"}, "priority": 100},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "preemptor",
             "req": {"cpu": "2", "memory": "4Gi"}, "priority": 100},
        ],
    }


def scheduling_churn(nodes=1000, measured=1000) -> dict:
    return {
        "name": f"SchedulingWithChurn/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "measurePods", "count": measured, "prefix": "measured",
             "churn_every": 10},
        ],
    }


def scheduling_node_affinity(nodes=5000, init_pods=5000, measured=1000) -> dict:
    """performance-config.yaml:257-281 SchedulingNodeAffinity: nodes all in
    zone1 (labelNodePrepareStrategy); every pod requires zone In [zone1,
    zone2] (pod-with-node-affinity.yaml)."""
    pod = {"req": {"cpu": "100m", "memory": "500Mi"},
           "node_affinity_in": {"topology.kubernetes.io/zone": ["zone-0", "zone-1"]}}
    return {
        "name": f"SchedulingNodeAffinity/{nodes}Nodes",
        "ops": [
            # zones=2 → every node in zone-0/zone-1, both admitted by the terms
            {"opcode": "createNodes", "count": nodes, "zones": 2},
            {"opcode": "createPods", "count": init_pods, "prefix": "init", **pod},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "na", **pod},
        ],
    }


def preferred_topology_spreading(nodes=5000, init_pods=5000, measured=2000) -> dict:
    """performance-config.yaml:310-335 PreferredTopologySpreading:
    ScheduleAnyway constraints (pod-with-preferred-topology-spreading.yaml,
    maxSkew 5) — pure Score-path spreading."""
    spread = {"req": {"cpu": "100m", "memory": "500Mi"},
              "spread_topology_key": "topology.kubernetes.io/zone",
              "spread_preferred": True, "max_skew": 5}
    return {
        "name": f"PreferredTopologySpreading/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 3},
            {"opcode": "createPods", "count": init_pods, "prefix": "init"},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "pspread", **spread},
        ],
    }


def migrated_intree_pvs(nodes=5000, init_pods=5000, measured=1000) -> dict:
    """performance-config.yaml:98-134 MigratedInTreePVs: in-tree EBS pairs
    evaluated through the CSI migration path (CSI limits instead of the
    in-tree counter). Shape-identical to InTreePVs here; the volume_type
    marks the claims as migrated EBS."""
    pod = {"req": {"cpu": "100m", "memory": "500Mi"},
           "pvc": {"volume_type": "ebs", "migrated": True}}
    return {
        "name": f"MigratedInTreePVs/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, "zones": 10},
            {"opcode": "createPods", "count": init_pods, "prefix": "init"},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "mpv", **pod},
        ],
    }


def preemption_pvs(nodes=500, init_pods=2000, measured=500) -> dict:
    """performance-config.yaml:409-435 PreemptionPVs: PreemptionBasic with a
    pre-bound PV/PVC pair per preemptor (pv-aws.yaml + pvc.yaml)."""
    return {
        "name": f"PreemptionPVs/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes,
             "capacity": {"cpu": "4", "memory": "16Gi", "pods": 32}},
            {"opcode": "createPods", "count": init_pods, "prefix": "victim",
             "req": {"cpu": "900m", "memory": "2Gi"}, "priority": 1},
            {"opcode": "createPods", "count": 8, "prefix": "warm",
             "req": {"cpu": "2", "memory": "4Gi"}, "priority": 100,
             "pvc": {"volume_type": "ebs"}},
            {"opcode": "barrier"},
            {"opcode": "measurePods", "count": measured, "prefix": "preemptor",
             "req": {"cpu": "2", "memory": "4Gi"}, "priority": 100,
             "pvc": {"volume_type": "ebs"}},
        ],
    }


def required_anti_affinity_ns_selector(nodes=5000, init_namespaces=100,
                                       init_pods_per_ns=40, measured=1000) -> dict:
    """performance-config.yaml:492-525
    SchedulingRequiredPodAntiAffinityWithNSSelector: labeled namespaces,
    40 init pods in each, measured pods in their own namespace carrying a
    required anti-affinity whose namespaceSelector spans the labeled set."""
    anti = {"req": {"cpu": "100m", "memory": "500Mi"},
            "ns_selector_anti_affinity": {
                "match_labels": {"color": "green"},
                "topology_key": "kubernetes.io/hostname",
                "ns_labels": {"team": "devops"}}}
    ops = [
        {"opcode": "createNodes", "count": nodes, "zones": 10},
        {"opcode": "createNamespaces", "count": init_namespaces,
         "prefix": "init-ns", "labels": {"team": "devops"}},
        {"opcode": "createNamespaces", "count": 1, "prefix": "measure-ns",
         "labels": {"team": "devops"}},
    ]
    for n in range(init_namespaces):
        ops.append({"opcode": "createPods", "count": init_pods_per_ns,
                    "prefix": f"init{n}", "namespace": f"init-ns-{n}", **anti})
    ops += [
        {"opcode": "barrier"},
        {"opcode": "measurePods", "count": measured, "prefix": "m",
         "namespace": "measure-ns-0", **anti},
    ]
    return {"name": f"SchedulingRequiredPodAntiAffinityWithNSSelector/{nodes}Nodes",
            "ops": ops}


# (tenant, DRR weight) for the soak's three asymmetric namespaces —
# quota caps scale with the weight, so the quota-weighted fair share and
# the DRR service share agree (the fairness bound the soak test asserts)
SOAK_TENANTS = (("soak-a", 4), ("soak-b", 2), ("soak-c", 1))


def scheduling_soak(nodes=1000, rounds=8, scale=24, cycles_per_round=120,
                    gangs=True, claims=True, preempt=True, flap=True,
                    tick_s=0.05, churn_frac=0.25, cohort="") -> dict:
    """SchedulingSoak — the compressed multi-tenant production mix: three
    namespaces with asymmetric SchedulingQuotas (weights
    4/2/1, pod caps proportional), each submitting MORE than its headroom
    every round so the QuotaAdmission gate engages, plus per-round churn
    that frees quota (driving the targeted release moves). The arrival mix
    layers gangs (soak-a), DRA claims (soak-b), and high-priority
    preemptors (soak-c) over the plain-pod base, and ``flap`` scripts one
    device flap mid-soak (tpu backend; no-op on oracle).

    ``scale`` is the per-weight-unit pod cap: soak-a holds ≤ 4·scale pods
    concurrently, soak-b ≤ 2·scale, soak-c ≤ scale. Per-round arrivals are
    ~weight·scale/2 per tenant, so after two rounds every ledger is at its
    cap and admission follows churn-freed headroom — which is proportional
    to the cap, hence to the weight: the quota-weighted fairness bound
    is measurable from the SoakTenant DataItems."""
    claim = {"claims": [{"name": "accel", "template": "soak-claim",
                         "class": "tpu.example.com",
                         "class_selectors": {"tpu.dev/gen": "v5"},
                         "selectors": {"tpu.dev/cores": ">=8"}}]}
    base = {"req": {"cpu": "100m", "memory": "500Mi"}}
    node_op = {"opcode": "createNodes", "count": nodes, "zones": 10,
               "capacity": {"cpu": "4", "memory": "16Gi", "pods": 32}}
    if claims:
        node_op["device_attributes"] = {"tpu.dev/cores": [8, 16],
                                        "tpu.dev/gen": ["v5", "v5", "v4", "v5"]}
    ops = [node_op]
    mix = []
    for ns, w in SOAK_TENANTS:
        # ``cohort`` joins all three tenants into one borrowing pool
        #: the soak's zero-oversubscription sampler then also
        # fences the cohort invariant (pool used ≤ pool guaranteed)
        ops.append({"opcode": "createQuota", "namespace": ns, "weight": w,
                    "cohort": cohort,
                    "hard": {"pods": w * scale,
                             "requests.cpu": w * scale * 1000,
                             "claims": w * scale}})
        mix.append({"namespace": ns, "count": max(w * scale // 2, 2), **base})
    if gangs:
        mix.append({"namespace": "soak-a", "count": 8, "gang_size": 8,
                    "every": 2, "prefix": "gang", **base})
    if claims:
        mix.append({"namespace": "soak-b", "count": max(scale // 2, 2),
                    "prefix": "claim", **base, **claim})
    if preempt:
        mix.append({"namespace": "soak-c", "count": 2, "every": 2,
                    "prefix": "preemptor", "priority": 100,
                    "req": {"cpu": "2", "memory": "4Gi"}})
    ops.append({"opcode": "soakPhase", "rounds": rounds, "mix": mix,
                "churn_frac": churn_frac, "cycles_per_round": cycles_per_round,
                "tick_s": tick_s,
                "flap": ({"round": rounds // 2, "batches": 3}
                         if flap else None)})
    suffix = "/Cohort" if cohort else ""
    return {"name": f"SchedulingSoak/{nodes}Nodes{suffix}", "ops": ops}


def scheduling_borrow(nodes=40, rounds=8, scale=12, cycles_per_round=60,
                      tick_s=0.05, borrowing=True) -> dict:
    """SchedulingBorrow — the asymmetric-cohort A/B:
    an idle lender (3·scale pod cap, trickle arrivals) and a hungry
    borrower (scale cap, scale arrivals per round) share one borrowing
    cohort; halfway through, the lender wakes up with a 2·scale-pod burst
    that with borrowing ON must be funded by reclaiming the borrower's
    loans. The OFF arm (``borrowing=False``) drops the cohort field only —
    same caps, same arrivals — so the BorrowInvariants utilization delta
    isolates what borrowing buys. Node capacity dwarfs the quota pool:
    admission, not placement, is the binding constraint. Acceptance (in
    the tests / trend fences): ON raises pool utilization by a real
    margin, lender e2e p99 stays within tolerance, zero borrow-aware
    oversubscription at every sampled instant."""
    cohort = "pool" if borrowing else ""
    base = {"req": {"cpu": "100m", "memory": "500Mi"}}
    ops = [{"opcode": "createNodes", "count": nodes, "zones": 4,
            "capacity": {"cpu": "4", "memory": "16Gi", "pods": 32}}]
    for ns, w, cap in (("borrow-lender", 2, 3 * scale),
                       ("borrow-hungry", 1, scale)):
        ops.append({"opcode": "createQuota", "namespace": ns, "weight": w,
                    "hard": {"pods": cap}, "cohort": cohort})
    mix = [
        {"namespace": "borrow-hungry", "count": scale,
         "prefix": "hungry", **base},
        # the lender's trickle keeps its e2e histogram populated in BOTH
        # arms — the p99 guardrail needs lender samples to compare
        {"namespace": "borrow-lender", "count": 1, "prefix": "lender",
         **base},
    ]
    burst = {"round": rounds // 2, "namespace": "borrow-lender",
             "count": 2 * scale - 4, "prefix": "wake", **base}
    ops.append({"opcode": "borrowPhase", "rounds": rounds, "mix": mix,
                "burst": burst,
                "pool": ["borrow-lender", "borrow-hungry"],
                "cycles_per_round": cycles_per_round, "tick_s": tick_s})
    arm = "" if borrowing else "/NoBorrow"
    return {"name": f"SchedulingBorrow/{nodes}Nodes{arm}", "ops": ops}


def scheduling_elastic(nodes=1000, rounds=6, pods_per_round=150,
                       storm_frac=0.3, drain_nodes=8, spot_frac=0.15,
                       cycles_per_round=120, tick_s=0.05, gangs=True) -> dict:
    """SchedulingElastic — cluster elasticity under load: a
    plain-pod base plus small gangs arrives every round while the chaos
    ladder rotates through a 30%-of-cluster add/remove storm (drain →
    delete → NEW node names, so DeviceState shrinks and its tombstoned
    slots/vocab retentions are reused), a rolling cordon/drain/rebind
    wave, and a mass spot reclamation riding the NoExecute taint-manager
    path. Judged by the ElasticInvariants DataItem: zero lost pods, zero
    oversubscription, bounded RowCapacity/HbmPeak under 2x-cluster churn,
    SlotReuses > 0, and UploadBytesSteady back at 0 after the storms."""
    base = {"req": {"cpu": "100m", "memory": "500Mi"}}
    node_params = {"zones": 10,
                   "capacity": {"cpu": "4", "memory": "16Gi", "pods": 32}}
    mix = [{"count": pods_per_round, "prefix": "el", **base}]
    if gangs:
        mix.append({"count": 8, "gang_size": 4, "every": 2,
                    "prefix": "elg", **base})
    return {
        "name": f"SchedulingElastic/{nodes}Nodes",
        "ops": [
            {"opcode": "createNodes", "count": nodes, **node_params},
            {"opcode": "elasticPhase", "rounds": rounds, "mix": mix,
             "storm_frac": storm_frac, "drain_nodes": drain_nodes,
             "spot_frac": spot_frac, "cycles_per_round": cycles_per_round,
             "tick_s": tick_s, "node_params": node_params},
        ],
    }


def scheduling_replay(nodes=500, rounds=16, scale=20, cycles_per_round=120,
                      churn_frac=0.3, tick_s=0.05, gangs=True,
                      rebalance=True, shift=True, bursts=True) -> dict:
    """SchedulingReplay — the continuous-rebalancing trace replay (ROADMAP
    item 3): three quota tenants ride a compressed diurnal arrival curve
    with scripted burst storms and a mid-trace tenant-mix shift, while
    per-round churn smears the load thin across the cluster — exactly the
    decay one-shot placement suffers in production. With ``rebalance`` on,
    the SLO-guarded Rebalancer runs its migration waves in the gaps;
    the ReplayInvariants DataItem carries packing-efficiency-over-time,
    final entropy/frag, and the max tenant e2e p99 — the "packing improves
    AND no tenant loses its p99" acceptance trend.py fences."""
    base = {"req": {"cpu": "100m", "memory": "500Mi"}}
    ops = [{"opcode": "createNodes", "count": nodes, "zones": 10,
            "capacity": {"cpu": "4", "memory": "16Gi", "pods": 32}}]
    mix = []
    for ns, w in SOAK_TENANTS:
        # caps sized so quota NEVER binds even after the mid-trace mix
        # shift triples the lightest tenant's arrivals: quota pressure is
        # the soak's acceptance, not this one — here the quotas exist to
        # label tenants for the e2e SLO histograms the guardrail watches
        ops.append({"opcode": "createQuota", "namespace": ns, "weight": w,
                    "hard": {"pods": (w + 2) * scale * 12,
                             "requests.cpu": (w + 2) * scale * 12000}})
        mix.append({"namespace": ns, "count": max(w * scale // 2, 2), **base})
    if gangs:
        # whole gangs only: replay_phase rounds gang arrivals down to a
        # multiple of gang_size, so keep the base count a multiple too
        mix.append({"namespace": "soak-a", "count": 8, "gang_size": 4,
                    "prefix": "gang", **base})
    ops.append({"opcode": "replayPhase", "rounds": rounds, "mix": mix,
                "churn_frac": churn_frac, "cycles_per_round": cycles_per_round,
                "tick_s": tick_s,
                "bursts": ({rounds // 4: 2.5, (3 * rounds) // 4: 2.0}
                           if bursts else None),
                "shift_round": (rounds // 2 if shift else None),
                "rebalance": (rebalance if isinstance(rebalance, dict)
                              else {"cooldown_s": 2.0, "score_interval_s": 0.5,
                                    "entropy_high": 0.85, "entropy_low": 0.70}
                              if rebalance else None)})
    return {"name": f"SchedulingReplay/{nodes}Nodes", "ops": ops}


TEST_CASES = {
    "SchedulingBasic": scheduling_basic,
    "SchedulingPodAntiAffinity": scheduling_pod_anti_affinity,
    "SchedulingPodAffinity": scheduling_pod_affinity,
    "SchedulingPreferredPodAffinity": scheduling_preferred_pod_affinity,
    "SchedulingPreferredPodAntiAffinity": scheduling_preferred_pod_anti_affinity,
    "SchedulingSecrets": scheduling_secrets,
    "SchedulingInTreePVs": scheduling_intree_pvs,
    "SchedulingCSIPVs": scheduling_csi_pvs,
    "SchedulingBorrow": scheduling_borrow,
    "SchedulingDRA": scheduling_dra,
    "SchedulingElastic": scheduling_elastic,
    "SchedulingGangs": scheduling_gangs,
    "SchedulingReplay": scheduling_replay,
    "SchedulingSlices": scheduling_slices,
    "SchedulingSoak": scheduling_soak,
    "MixedSchedulingBasePod": mixed_scheduling_base_pod,
    "TopologySpreading": topology_spreading,
    "Unschedulable": unschedulable,
    "PreemptionBasic": preemption_basic,
    "SchedulingWithChurn": scheduling_churn,
    "SchedulingNodeAffinity": scheduling_node_affinity,
    "PreferredTopologySpreading": preferred_topology_spreading,
    "MigratedInTreePVs": migrated_intree_pvs,
    "PreemptionPVs": preemption_pvs,
    "SchedulingRequiredPodAntiAffinityWithNSSelector": required_anti_affinity_ns_selector,
}
