#!/usr/bin/env python3
"""Drive kubernetes_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

1. Build: compiles the fused-step kernel (kubernetes_tpu_torch/csrc/
   fused_step.cu) from the checkout with nvcc and prints its resource report.
2. Kernel phase: the CUDA kernel against its plain PyTorch version on the
   card at the main-path sizes (N=5120 node slots, R=6, W=16, P=128): five
   seeded batches (random; floor boundaries; ties, host ports, padded pods
   and nodes, a nominated pod; slices: exact ties at every boundary of the
   kernel's 8-block node split, winners in all 8 slices, a pod with no
   feasible node and a nominated node in the last slice; masked: a volume
   screen and a claim mask on about a third of the cells, first-fail ids 9
   and 10 under the static ids 1-4, and three pods with every node masked)
   plus a real SchedulingBasic batch. Every output and the evolved carry
   must be exactly equal, and the slices batch must pick the winners it was
   built for. Times the kernel (median of CUDA-event timings over 30
   launches) and the plain version on the SchedulingBasic batch, the kernel
   on the masked batch, and works out the least time the card could take
   for the same work. It runs alone; then the phases below run in three
   processes at once on the same card (``chip_smoke.py --group NAME``,
   started by this script and stopped by it on any failure or past
   GROUPS_DEADLINE_S), each phase in the group of the phases whose results
   it reads: core (3-5, 11, 20), batch (6, 8-10, 12-13, the shard phase
   of 21) and loop (the loop_basic part of 11, then 14-19, then 7, then
   the shard_scale phase of 21). Each group's output is
   printed in that order once all have ended, a failed group's last.
3. Slice phase: SchedulingBasic/5000Nodes (5000 nodes of cpu 32 / 128Gi /
   110 pods with zone and hostname labels; pods asking 900m / 2Gi) through
   BatchScheduler on the card with the default ``KTPU_SPEC=auto``: 1000
   init-* pods, then 1000 measured-* pods. Every pod must be placed, every
   batch must take the fused kernel, which must have launched once per
   batch, and the placements must equal the same run on the CPU (plain
   versions).
4. Topology phase: the topology-size log table on the card must equal the
   CPU's for every size 0..8194; prints its build's CUDA-event ms and
   kernels (once per topology batch). Then, with the scan forced
   (``KTPU_SPEC=0``), SchedulingPodAntiAffinity/5000Nodes (1000 init + 1000
   measured pods, each anti-affine to the others on the hostname key) and
   TopologySpreading/5000Nodes (5000 plain init pods, then 2000 pods with a
   maxSkew 1 DoNotSchedule zone constraint) through BatchScheduler on the
   card, then on the CPU. Every pod must be placed; the anti-affine pods on
   2000 distinct nodes; the spread pods' per-zone counts within 1 of each
   other; every topology batch in the expected mode ("host", "general");
   the fused kernel launched by no topology batch; no host read inside a
   scan batch's device call (it runs under
   ``torch.cuda.set_sync_debug_mode("error")``); and the placements equal
   to the CPU run.
5. Spec phase: the three workloads again on the card with every batch
   forced to the speculative rounds (``KTPU_SPEC=1``). The placements and
   modes must equal the CPU run and the card's run of the fused kernel or
   the scan; in every batch (but the profiled one) the host reads, counted
   as the synchronising-operation warnings of
   ``set_sync_debug_mode("warn")``, must equal the rounds
   (``batch.ROUNDS``); and one measured batch's spec BatchResult on the
   card must equal, field by field and bit for bit, the rounds on the CPU
   from the same inputs. Prints rounds per batch, kernels per round, device
   busy ms, ms per batch and pods/s beside the path the rounds replace.
   Then times the two paths in turns (other, spec, spec, other) on that
   batch's inputs and prints which is faster per mode beside
   ``batch.SPEC_AUTO_CUDA`` (the path ``auto`` takes on the card); fails if
   the table takes a path this run measured more than 1.5 times slower.
6. DRA phase: SchedulingDRA/5000Nodes (nodes publishing tpu.dev/cores and
   tpu.dev/gen; 1000 init + 1000 measured pods with one claim each, class
   gen == v5, claim cores >= 8) and SchedulingInTreePVs/5000Nodes (5000
   init + 1000 measured pods, each with its own pre-bound EBS PV and PVC)
   through BatchScheduler with their object stores, on the card under
   ``KTPU_SPEC=auto`` (every batch on the fused kernel, one launch per
   batch), on the CPU, and on the card with the rounds forced. Every pod
   must be placed with nothing in ``retry`` or ``fallback``; placements and
   claim allocations equal across the three runs; every DRA pod on a gen v5
   node with its claim allocated there; one measured batch's claim mask
   (and volume screen) from the card equal to the CPU's bit for bit. Prints
   the claim mask's device ms (CUDA events) and the host ms per batch of the
   volume screen, the claim mask's build and the commit checks.
7. Preempt phase: PreemptionBasic/500Nodes (500 nodes of cpu 4 / 16Gi /
   32 pods; 2000 victims of 900m / 2Gi at priority 1; 8 warm and 500
   measured preemptors of 2 / 4Gi at priority 100) and PreemptionPVs/
   500Nodes (the same, each preemptor with its own pre-bound EBS PV and
   PVC) through BatchScheduler: the init, warm and measured pods, then the
   nominated pods resubmitted until none is left (at most 16 rounds;
   ``perf/workloads.py:run_with_preemption``), on the card under
   ``KTPU_SPEC=auto`` (every batch on the fused kernel), on the CPU, and
   on the card with the rounds forced. All 508 preemptors must be bound,
   nothing left nominated, in ``retry`` or in ``fallback``; every node's
   requests within its allocatable; placements, the nominations before
   each round and the victims (victim -> preemptor) equal across the three
   runs. On the failing batch with the most failed pods, the screen
   (``ops/preempt.py``) on the card must equal the CPU's exactly and read
   nothing to the host (``set_sync_debug_mode("error")``). Prints ms per batch by stage, ms per failing
   batch of the screen (CUDA events) and of the host Evaluator, the
   screen's CUDA kernels and device busy time (torch.profiler), rounds and
   victims.
8. Gang phase: SchedulingGangs/5000Nodes (5000 nodes in 10 zones; gangs
   of 8 and 32, each member anti-affine to its own PodGroup on the
   hostname key: 160 init + 320 measured pods) and SchedulingSlices/
   512Nodes (512 hosts of cpu 4 / 16Gi labelled superpod i // 64, slot
   i % 64; slice gangs of 2, 8 and 64 hosts: 4 init + 88 measured pods)
   through BatchScheduler with their object stores (PodGroups), on the card
   under ``KTPU_SPEC=auto`` (Gangs: the rounds; Slices: the fused kernel
   with the slice mask), on the CPU, and on the card with the other path
   forced (Gangs: the scan; Slices: the rounds). Every gang must be bound
   whole, with ``gang_rejected``, ``retry`` and ``fallback`` empty; each
   SchedulingGangs gang on distinct hosts; each slice gang on consecutive
   slots of one superpod, one member per host (0 contiguity violations);
   placements equal across the three runs; every SchedulingSlices batch on
   the fused kernel. On one measured batch of each, the slice plan (mask
   and words) and ``gang_verdicts`` (from the card's batch result) on the
   card equal the CPU's bit for bit, and run under
   ``set_sync_debug_mode("error")``. A reject case follows on a 128-host
   torus, on the card and on the CPU: a gang of 8 anti-affine members
   confined to 6 hosts and a slice gang of 65 hosts (wider than a
   superpod) are rejected whole, and after the next sync the device's
   requested equals a fresh encode of the cluster. Prints ms per batch by
   stage, the plan's and the verdicts' CUDA-event ms and CUDA kernels, and
   the fused kernel's ms on the slice-masked batch against the same batch
   without the mask.
9. Quota phase: SchedulingSoak/1000Nodes, SchedulingSoak/1000Nodes/
   Cohort and SchedulingSoak/1000Nodes/NoGangs (1000 nodes of cpu 4 / 16Gi
   / 32 pods in 10 zones publishing SchedulingDRA's device attributes;
   tenants soak-a / soak-b / soak-c with SchedulingQuotas of weights 4 / 2
   / 1 at scale 24, in one cohort in the second; 8 rounds of plain pods,
   soak-a's gangs of 8 (not in the third), soak-b's claim pods and
   soak-c's priority-100 preemptors, a quarter of each tenant's bound pods
   deleted after each round) through ``perf/workloads.py:run_soak`` on the
   card under ``KTPU_SPEC=auto``, on the CPU, and on the card with the
   rounds forced. Zero oversubscription at every pass; placements, the
   pods left pending, per-round ledgers and nominations, the quota, gang
   and screen rejections equal across the three runs; the fused kernel
   launched once per mode-off batch (the gangs' anti-affinity puts the
   first two in mode host throughout; every /NoGangs batch is mode off);
   in the rounds, host reads equal to rounds; at least one winner flagged
   by the device screen in a batch whose tenant the gate had let through
   whole (for /NoGangs, in a batch of the fused kernel); the screen on the
   batch with the most screened rows on the card equal to the CPU's and
   free of host reads (``set_sync_debug_mode("error")``). Prints ms per batch by
   stage, the gate's and the screen's counts per tenant, and the screen's
   CUDA-event ms, CUDA kernels and device busy time.
10. PreemptionAll phase: PreemptionBasic's 500 nodes and 2000 priority-1
   victims, with zone and hostname labels and SchedulingDRA's device
   attributes, then 128 priority-100 preemptors of 2 / 4Gi with a claim
   (mode off, the fused kernel), 128 anti-affine on the hostname key (mode
   host) and 128 with a zone spread constraint (mode general), each kind
   in its own batch, through ``run_with_preemption`` (at most 16 rounds)
   on the card (auto), on the CPU and on the card with the rounds forced:
   every preemptor bound, nothing nominated, in ``retry`` or in
   ``fallback``, every node within its allocatable, placements,
   nominations and victims equal across the three runs; per mode, the
   screen on its failing batch with the most failed pods equal on card and
   CPU and free of host reads. Prints the first failing batch of each mode
   (ms, screen, host Evaluator) and the screen's ms, kernels and busy time
   per mode.
11. Loop phase: the scheduler loop (``perf/workloads.py:run_loop``: nodes
   and pods created in the port's Store, ``TPUScheduler(store,
   device).run_until_settled()``, every bind through the store). Its
   SchedulingBasic and PreemptionBasic runs are the loop_basic phase, at
   the head of the loop group. SchedulingBasic/5000Nodes (1000 init, then 1000 measured pods) on the
   card at the default percentageOfNodesToScore (a full batch on CUDA),
   three times in turns: the in-flight ring at its default (depth 2, its
   commits inline), the synchronous loop (``KTPU_PIPELINE_DEPTH=0``) and
   the ring with the commit worker (``KTPU_COMMIT_WORKER=1``).
   Each run: every pod bound, every batch on the fused kernel with
   launches (counted from 0 just before the run) equal to batches,
   placements and pods popped equal to the loop on the CPU at percentage
   100 (the inline ring, the plain fused step); each ring run with batches
   encoded on the carry. Then one inline-ring dispatch on the carry (the
   third) under ``set_sync_debug_mode("error")`` (the ring at the default
   deadline runs in the loop_faults phase); SchedulingPodAntiAffinity/5000Nodes and
   TopologySpreading/5000Nodes through the ring (placements, pods popped,
   modes and grown capacities equal to the CPU loop); the sampled loop
   (1000 nodes, 256 pods at percentage 10: every batch on the scan, no
   kernel launch, placements and the window's final start equal to the
   CPU run); PreemptionBasic/500Nodes through the inline ring (victims,
   nominations, placements, pods popped and counters equal to the CPU)
   and through the worker ring (every preemptor bound; nominations, victims
   and pods popped printed beside the CPU's). Prints per run pods/s of the
   measured phase, attempt p50/p90/p99 (pop to commit), the batches
   encoded on the carry, host ms per batch on the scheduling thread by
   stage (pop, snapshot, sync, encode, dispatch, commit), the commits' ms
   (wait, bind, reconcile), and with the worker the overlap: the ms its
   host commits ran beside the scheduling thread's encode and dispatch.
12. Loop_gang phase: gangs, torus slices and namespace quota through the
   loop, each on the card (the inline ring) and on the CPU in this call.
   SchedulingGangs/5000Nodes and SchedulingSlices/512Nodes through
   ``run_loop`` (a gang's PodGroup created just before its first member):
   every pod bound, every gang whole and Running, nothing waiting at
   Permit, and placements, gang rejections, PodGroups, pods popped per
   batch and modes equal to the CPU loop; every SchedulingSlices batch mode
   ``off`` with one fused launch each and 0 contiguity violations.
   SchedulingSoak/1000Nodes/Cohort and /NoGangs, with their claim pods,
   through ``run_loop_soak`` (the JAX harness's soak phase: 8 rounds of arrivals,
   up to 120 batch cycles each on a FakeClock advanced 50 ms per cycle, a
   quarter of each tenant's bound pods deleted after each round):
   placements, binds per tenant, ledgers per round, pods popped per batch,
   the queue at the end, evictions of the reclaim pass, flagged winners,
   rejections and PodGroups equal to the CPU loop; zero oversubscription
   at every check; nothing waiting at Permit; one fused launch per mode-off
   batch, every /NoGangs batch mode ``off`` with a winner flagged after
   the kernel. Prints per run pods/s, attempt p50/p99, ms per measured
   batch (or per cycle that ran a batch), host ms by stage and commit ms,
   the gang verdicts' ms and reads, beside BatchScheduler's ms per batch
   for the same workload from the gang and quota phases.
13. Loop_claims phase: claims and volumes through the loop (the inline
   ring), each on the card and on the CPU in this call, in one process:
   SchedulingDRA/5000Nodes (1000 init + 1000 measured claim pods),
   SchedulingInTreePVs/5000Nodes and SchedulingCSIPVs/5000Nodes (each pod
   with its own pre-bound PV and PVC; CSINodes allowing 39 volumes; 1000
   init pods instead of the published 5000, then 1000 measured) through
   ``run_loop``, with each op's claims, PVs and PVCs in the store before
   its pods; SchedulingSoak/1000Nodes with its claim pods through
   ``run_loop_soak``; and the seeded delayed-binding case (500 nodes, 128
   pods with WaitForFirstConsumer PVCs, 96 zonal PVs, then 16 more) through
   ``run_delayed_binding``. Each: placements, pods popped per batch,
   counters, PV bindings, claim allocations and the pods the sequential
   path bound equal to the CPU run; one fused launch per full mode-off
   batch; no CSINode limit exceeded, no ReadWriteOncePod claim shared,
   every claim allocated to its pods' node; every pod bound (the delayed
   case: every PV bound to one pod on a node of its zone). Prints pods/s,
   attempt p50/p99, host ms per measured batch by stage and the claim
   and volume ms (the volume screen, the claim mask, the commit checks).
14. Loop_faults phase: the loop's failure model on the card.
   SchedulingSoak/1000Nodes/NoGangs (with its claim pods) through
   ``run_loop_soak`` with the device flap (the first three batch commits
   of round 4 die at their read: the relay breaker opens, every batchable
   pod takes the sequential path until the 0.5 s probe commits) and the
   oracle comparer on every 8th landed winner, on the card and on the CPU:
   placements, binds per tenant, pods popped, the flap's batches, the
   degraded pods and seconds, the sequential binds, the breaker's state
   after every cycle and the comparer's checks equal; no comparer
   mismatch, no oversubscription, the breaker closed at the end. The
   relay death (``perf/workloads.py:run_relay_death``) at
   SchedulingBasic/1000Nodes: commits die until the breaker opens
   (threshold 2), 192 pods retried or arriving while it is open take the
   sequential path, and past its 5 s probe interval a probe batch closes
   it; every step (breaker state, openings, degraded pods, sequential
   binds, batches, mirror) and every placement equal to the CPU loop's,
   and while the breaker is open no batch is dispatched, the fused kernel
   is not launched and the loop holds no mirror on the card. Then the
   ring at the 500 ms default deadline in turns (cold, warmed, warmed,
   cold) at SchedulingBasic/5000Nodes, each run's placements equal to the
   CPU loop's at percentage 100; a warmed turn runs ``warm_buckets`` with
   one measured pod as the sample after the init pods settle. In the
   first warmed turn every fused launch of the sweep (P = 16, 32, 64, 128)
   is held against ``fused_step_batch_ref`` on the same inputs bit for
   bit; in each, the launches are counted apart (``warm_launches``) and
   every tensor of the mirror is unchanged across the sweep. Prints
   pods/s, attempt p50 and p99, the popped batch sizes, the measured
   phase's first batch ms at each bucket, and for a warmed turn the
   sweep's seconds, its timed run per bucket and the sizer's fitted
   model. A "cold" turn is cold for its loop only: the process has run
   every bucket in earlier phases. Every loop run outside the flap and
   the relay death must leave the relay
   breaker closed with no pod degraded (a kernel that failed quietly into
   the host path fails the smoke); the soaks of the loop_gang and
   loop_claims phases run with the flap too, each checked like this one.
15. Loop_profiles phase: the loop built from a KubeSchedulerConfiguration
   (``config.scheduler_from_config``, through ``run_loop``'s ``config``),
   on the card (the inline ring) and on the CPU in this call.
   SchedulingBasic/5000Nodes with two batchable profiles,
   ``default-scheduler`` and ``batch-b`` (the default set through
   multiPoint), the 1000 measured pods alternating between them: every
   batch on the fused kernel, launches equal to batches, nothing on the
   sequential path, placements equal to the CPU loop of the same config;
   prints pods/s and attempt p99 per profile. SchedulingBasic/1000Nodes (500
   init, 256 measured pods, 64 of them on ``most-allocated``, the C20
   profile, and 64 on ``no-scoring``): the 128 custom pods take the
   sequential path (``fallback_scheduled`` 128), the rest the kernel, and
   placements equal the CPU loop's. PreemptionBasic/500Nodes with its
   priorities from PriorityClasses (``low`` 1, ``high`` 100) through the
   config-built loop: every preemptor bound; placements, victims and
   nominations equal to the loop_basic phase's numeric-priority runs on the card
   and on the CPU.
16. Loop_admission phase: the store's admission chain and the scheduler
   extenders through the loop, on the card (the inline ring) and on the
   CPU in this call. SchedulingBasic/5000Nodes/Admission
   (``workloads.admission_basic``): nodes 0-499 created not Ready, 500-749
   with the unreachable NoExecute taint, pool=a / pool=b in halves; the
   1000 measured pods spread over ``default``, team-a (node-selector
   annotation pool=b), team-b (a LimitRange defaulting 500m / 1Gi; its pods
   set no requests) and team-c (a RuntimeClass of 250m overhead, a
   ResourceQuota of 200 pods): placements, the creates refused per plugin
   (50, by ResourceQuota) and the counters equal to the CPU loop's; no pod
   on a not-Ready node, every team-a pod on pool=b, every admitted team-c
   pod charged its overhead (``workloads.admission_violations``). The
   chain's cost: SchedulingBasic/5000Nodes with the chain and validation
   on, then off (``admission = None``, ``validation_enabled = False``), 2
   pairs in turns; prints the median pods/s of each and the µs of a
   measured create. SchedulingBasic/1000Nodes/Extender (500 init, 256
   measured pods, a quarter on ``no-scoring``) with an in-process
   ``workloads.LoopExtender``: placements and calls per verb equal to the
   CPU run's, no sequential pod on a node the Filter drops, every pod bound
   through the extender; prints the batch pods on filtered nodes (ROADMAP
   C22). PreemptionBasic/500Nodes with a preempt-capable extender that
   keeps every other candidate node: victims and nominations equal to the
   CPU run's. The same extender behind a ``ThreadingHTTPServer`` on
   127.0.0.1, configured by urlPrefix with its four verbs, for 64 pods on
   ``no-scoring`` at 1000 nodes: placements and calls equal to the
   in-process run of the same pods; prints the ms per POST per verb.
17. Loop_telemetry phase: the observability layer through the loop on the
   card (``perf/workloads.py:LoopObserver``: telemetry, the latency ledger
   and tracing on for a whole run). SchedulingBasic/5000Nodes on the inline
   ring with the recorders off and on in turns (2 pairs): every run's
   placements equal the loop_basic phase's CPU run, and on equals off in this
   process; prints pods/s and attempt p99 of both (the layer's cost). From
   each run with the recorders on: the dispatch ledger's ``schedule_batch``
   count must equal the fused launches and the batches; the median
   ``deviceExecS`` (the batch program between two CUDA events) beside the
   kernel phase's ms; the dwell / exec / fetch medians; the fused step's
   bytes over the median ``deviceExecS`` against 3.35 TB/s; the card's
   busy share of the measured phase (the ``deviceExecS`` committed in it
   over its wall seconds); upload and fetch bytes and the allocator's peak;
   builds and retraces (retraces must be 0); every closed ledger entry's
   e2e equal to the sum of its segments to 1e-9 relative, one closed
   ``scheduled`` entry per pod bound, e2e p50 / p99 and the median of each
   segment; one ``scheduling.cycle`` span per batch and the
   ``device.dispatch.*`` spans lying end to end in their
   ``device.commit.wait``. Then SchedulingBorrow/1000Nodes and
   /1000Nodes/NoBorrow (``workloads.run_loop_borrow``: 8 rounds at scale
   100, 60 cycles of 0.05 s on a FakeClock per round) on the card and on
   the CPU at percentage 100: placements, per-tenant admissions, loans,
   reclaims, the invariants and the ledger's per-tenant e2e observations
   equal; zero oversubscription in both arms, reclaims with borrowing on,
   and a pool-utilization lift above 0.10 (``tests/test_borrow.py``'s
   bar); prints pods/s and the lender's e2e p99 of both arms.
18. Loop_rebalance phase: the drain orchestrator and the SLO-guarded
   rebalancer through the loop on the card. ``packing_entropy`` (the
   rebalancer's score, plain PyTorch) on SchedulingBasic/5000Nodes'
   settled mirror (N = 5120, R = 6) and on the smeared mirror at the end of
   the replay, against its plain version on the CPU within 1e-6; prints
   its CUDA-event ms (median of 30), its kernel launches per call
   (torch.profiler's cudaLaunchKernel calls), the plain version's ms and the least time for its
   bytes. SchedulingReplay/500Nodes and /NoRebalance
   (``workloads.run_loop_replay``: 16 rounds at scale 20, 120 cycles of
   0.05 s on a FakeClock per round, the rebalancer at cooldown 2 s, score
   interval 0.5 s, band 0.85 / 0.70) on the card and on the CPU at
   percentage 100: placements, the ReplayInvariants, the waves and their
   victims and the per-tenant e2e equal; the JAX test's bar: waves with
   the rebalancer on, none off, nothing pending, no uncordon pending, no
   tenant p99 past 3x the /NoRebalance arm's + 0.5 s; prints pods/s, the
   ms of each score inside the loop, and PackingEff of both arms (on the
   batch loop the rebalancer gets one wave and the two arms differ by
   under 1e-7, the JAX loop's as the port's:
   ``tests/torch_replay_default_size.py``). SchedulingReplay/24Nodes one
   pod per cycle with the JAX test's knobs (its size and mode), both arms
   on the card and on the CPU, equal, with the whole bar: the above and
   PackingEff on above off by 0.005, FinalEntropy on below off; prints
   the fused launches (none: the sequential path) and pods/s.
   SchedulingElastic/1000Nodes (``workloads.run_loop_elastic``: 6 rounds of
   150 pods and gangs, the storm, the rolling drain and the spot
   reclamation) on the card and on the CPU: placements, the
   ElasticInvariants, the evictions and the nodes equal; no pod lost, no
   node oversubscribed, nothing pending, slots reused, the node axis at
   ``caps_for_cluster(1000).nodes`` and no upload in the settled second
   sync; prints pods/s and the evictions by reason.
19. Loop_wire phase: the batched device service over HTTP on the card
   (``backend/service.py``; ``perf/workloads.py:run_loop_wire``):
   ``WireScheduler`` against ``serve(DeviceService(device="cuda"))`` on
   127.0.0.1, in this process. SchedulingBasic/5000Nodes at batch 128,
   pipeline depth 0 and 3 in turns (two pairs), held against the loop
   phase's CPU run at percentage 100: every pod bound, pods per batch,
   counters and the queue equal to it, and at depth 0 the placements too
   (at depth 3 the service runs the batches in flight in the order their
   handler threads take its lock, ROADMAP C26; the pods placed elsewhere
   are printed); every batch on the fused kernel, launches (counted from 0
   just before each run) equal to the batches the service ran and to
   those the client sent; no replay, resync or conflict.
   PreemptionBasic/500Nodes at depth 0: the hints from the screen on the
   card, nominations and placements equal to a CPU service's run (the
   loop's screen chooses other victims at this size).
   SchedulingBasic/1000Nodes with two replicas on one card service (depth
   3, one cycle each in turn): one accepted placement and one bind per
   pod, no bind of a bound pod, no node over capacity, conflicts counted
   by the clients equal to the service's. SchedulingBasic/500Nodes (256
   init, 512 measured pods) with ``ServiceBinding.restart`` after 3 of
   its 6 batches: one full resync, no batch run twice, placements equal
   to a CPU service's run with the same restart. Prints pods/s, attempt
   p50 / p99, the per-batch split (the client's payload encode and delta
   push, the transport, the service's decode, sync, encode, dispatch, read
   and commit) and the echoed deviceTime (dwell / exec / fetch of the
   read, the batch program's CUDA events); the wire runs have telemetry on
   (for the echoed deviceTime).
20. Loop_fabric phase: the device fabric on the card
   (``backend/fabric.py``): one ``WireScheduler`` over two
   ``serve(DeviceService(device="cuda"))`` replicas on 127.0.0.1, every
   CPU reference this phase's own run. SchedulingBasic/1000Nodes (500 init
   and 500 measured pods, depth 0) with the primary's endpoint killed
   (``FaultPlan.kill``) after its third batch, with cold standbys and then
   warm ones (the replicator on): one transient failover to the standby,
   every pod bound once, launches equal to the batches the replicas ran
   (per replica too), the primary's three batches run once, and the
   placements, pods per batch, counters and queue of the same script on
   two CPU services; the warm promote's resync uploads fewer row bytes
   than the cold one's full seed. SchedulingBasic/1000Nodes (256 + 256
   pods) with both replicas killed, then one healed (a FakeClock): the
   breaker opens with nothing dispatched, the init pods take the
   sequential path, the measured pods the batched path on the healed
   replica, placements equal to the CPU's. When grpc and protobuf are
   installed (decided from ``importlib.util.find_spec``, and printed),
   SchedulingBasic/5000Nodes over gRPC (``serve_grpc``) and over HTTP at
   depth 0: placements, counters and queue equal to a CPU loop run, one
   fused launch per batch. Prints the failover ms, the promote bytes warm
   against cold, ``standby_resync_bytes`` by kind, pods/s, attempt p50 /
   p99, and the gRPC per-batch split and request bytes beside HTTP's.
21. Shard phase: node-axis sharding of the batch program
   (``kubernetes_tpu_torch/parallel/``), each world size W as W processes
   (``parallel.launch.run_ranks``), every rank on this one card.
   SchedulingBasic/5000Nodes, one 128-pod batch (N=5120): at W=1 over NCCL
   the sharded scan and rounds each equal, bit for bit, the unsharded
   batch on the fused kernel; at W=2 and 4 over gloo each equals the same
   program's gloo run on the CPU. TopologySpreading/5000Nodes (mode
   general; the scan and the rounds) and SchedulingPodAntiAffinity/
   5000Nodes (mode host; the rounds, the card's path for it), one measured
   batch each (their init pods bound one per node) at W=4, each equal to
   the single-device run on the card and to the CPU's W=4 run.
   Shard_scale phase: the stretch shape of tests/test_stretch_50k.py
   (50,000 nodes in 65,536 slots, 64 pods) at W=8: the scan equals the
   rounds, every winner valid and distinct; then
   ``entry.dryrun_multichip(4)`` on the card. Both print ms per batch, the
   collectives and their bytes per batch, each rank's allocator peak, and
   that every rank shared one card (no multi-card run exists, so the times
   measure no scaling); every sharded run's fused launches on every rank
   are counted (0: the sharded program takes the scan or the rounds) and
   join the launches map.
22. Each workload run prints pods/s, ms per batch, host ms per stage, and
   the CUDA kernels and device busy time of one measured batch
   (torch.profiler). Then the card's name and power limit, one JSON line of
   per-kernel numbers, and, as the last line, the device summary.

Exits non-zero, with no result line, when any phase fails or when no CUDA
device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from kubernetes_tpu_torch.api.wrappers import make_node, make_pod
from kubernetes_tpu_torch.backend import batch, batch_scheduler, claim_mask, tpu_scheduler
from kubernetes_tpu_torch.backend.batch_scheduler import BatchScheduler
from kubernetes_tpu_torch.backend.device_state import DeviceState
from kubernetes_tpu_torch.framework.types import NodeInfo
from kubernetes_tpu_torch.ops import fused_step, preempt, topology
from kubernetes_tpu_torch.perf import sharding, workloads
from kubernetes_tpu_torch.perf.kernel_phases import scheduling_basic_args
from kubernetes_tpu_torch import entry as port_entry
from kubernetes_tpu_torch.parallel import launch

N_NODES = 5000
N_PODS = 1000
P, R, W = 128, 6, 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TIMED_LAUNCHES = 30


# ---------------------------------------------------------------- kernel phase

def _seeded_batch(kind: str, seed: int, n: int = 5120, n_real: int = 5000) -> dict:
    rng = np.random.RandomState(seed)
    real = np.arange(n) < n_real
    if kind == "boundary":
        caps = np.array([3, 7, 1000, 4, 5, 8, 10, 100, 25, 50], np.int32)
        alloc = caps[rng.randint(len(caps), size=(n, R))]
        nz = (alloc * rng.randint(0, 5, size=(n, R))) // 4
        p_req = rng.choice([0, 1, 2, 5], size=(P, R))
    else:
        alloc = rng.choice([32000, 134217728 // 1024 * 1024, 110, 16000, 65536], size=(n, R))
        alloc[:, 0] = rng.choice([3000, 7000, 32000], size=n)
        nz = (alloc * rng.uniform(0, 0.9, size=(n, R))).astype(np.int64)
        p_req = rng.choice([0, 1, 100, 900, 2048], size=(P, R))
    alloc = np.where(real[:, None], alloc, 0).astype(np.int32)
    nz = np.where(real[:, None], nz, 0).astype(np.int32)
    valid = np.ones(P, bool)
    nominated = np.full(P, -1, np.int32)
    ports = np.zeros((n, W), np.int64)
    p_bits = np.zeros((P, W), np.int64)
    jitter = rng.randint(0, 1 << 24, size=(P, n)) * (0.5 / (1 << 24))
    if kind == "ties":
        valid[-8:] = False                     # padded pods
        nominated[3] = 4242                    # a nominated pod
        ports[rng.uniform(size=(n, W)) < 0.02] = 1 << rng.randint(0, 32, size=1)[0]
        for i in range(0, P, 2):
            p_bits[i, i % W] = 1 << (i % 32)   # host ports wanted
        jitter[:, : n // 2] = 0.0              # exact ties: the first index wins
        alloc[: n // 2] = alloc[0]
        nz[: n // 2] = nz[0]
    static_ok = (rng.uniform(size=(P, n)) < 0.95) & real[None, :] & valid[:, None]
    ff = np.where(static_ok, 0, rng.randint(1, 5, size=(P, n)))
    if kind == "masked":
        # the volume screen (id 9) and the claim mask (id 10) under the
        # static ids, as static_phase assigns them; pods 0, 7 and 77 have
        # every node masked by claims
        extra = rng.uniform(size=(P, n)) > 1 / 6
        dra = rng.uniform(size=(P, n)) > 1 / 6
        dra[[0, 7, 77]] = False
        ff = np.where(ff > 0, ff, np.where(~extra, 9, np.where(~dra, 10, 0)))
        static_ok &= extra & dra
        ff = np.where(static_ok, 0, np.where(ff > 0, ff, 1))
    as_i32 = lambda a: (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)  # noqa: E731
    return {
        "alloc": alloc, "requested": (nz * 0.8).astype(np.int32), "nonzero": nz,
        "ports": as_i32(ports), "p_req": p_req.astype(np.int32),
        "p_nz": np.maximum(p_req, 1).astype(np.int32), "p_bits": as_i32(p_bits),
        "static_ok": static_ok, "static_ff": ff.astype(np.int8),
        "taint": rng.randint(0, 3, size=(P, n)).astype(np.float32),
        "aff": rng.choice([0, 2, 5], size=(P, n)).astype(np.float32),
        "img": rng.choice([0, 0, 17], size=(P, n)).astype(np.float32),
        "jitter": jitter.astype(np.float32), "nominated": nominated, "p_valid": valid,
    }


def _slices_batch(seed: int, n: int = 5120, n_real: int = 5000):
    """A batch aimed at the kernel's split of the node axis into CLUSTER
    slices of m = ceil(n / CLUSTER) slots. Every real node has the same
    state in the two scored columns, and each commit adds 1 to both, so
    LeastAllocated stays 99 and BalancedAllocation 100 on every node: totals
    differ only by the taint, affinity and image rows. Each pod gives its
    tie nodes the best raw scores and a jitter of 0.5 and every other node a
    jitter below 0.25, so the first tie node wins:
      * pods p % 3 == 0: a tie across the boundary (k*m - 1, k*m);
      * pods p % 3 == 1: a tie between k*m and a node of the last slice;
      * pods p % 3 == 2: one tie node in each slice from s = p % 8 on;
    with k = 1 + p % 7. Pod 5 has no feasible node, pod 9 is nominated to a
    node of the last slice, and the last two pods are padding. Returns the
    kernel's inputs and the winner each pod must get."""
    rng = np.random.RandomState(seed)
    m = -(-n // fused_step.CLUSTER)
    real = np.arange(n) < n_real
    alloc = np.where(real[:, None], np.full((n, R), 32000), 0).astype(np.int32)
    nz = np.where(real[:, None], np.full((n, R), 160), 0).astype(np.int32)
    p_req = rng.choice([0, 1, 2], size=(P, R)).astype(np.int32)
    p_nz = np.maximum(p_req, 1)
    p_nz[:, :2] = 1
    valid = np.ones(P, bool)
    valid[-2:] = False
    static_ok = (rng.uniform(size=(P, n)) < 0.97) & real[None, :] & valid[:, None]
    taint = rng.randint(0, 3, size=(P, n)).astype(np.float32)
    aff = rng.choice([0, 2, 5], size=(P, n)).astype(np.float32)
    img = rng.choice([0, 17], size=(P, n)).astype(np.float32)
    jitter = rng.randint(0, 1 << 24, size=(P, n)) * (0.25 / (1 << 24))
    nominated = np.full(P, -1, np.int32)
    want = np.full(P, -1, np.int32)
    last = (fused_step.CLUSTER - 1) * m
    for p in range(P - 2):
        k, s = 1 + p % 7, p % 8
        ties = ([k * m - 1, k * m] if p % 3 == 0 else
                [k * m, last + 5] if p % 3 == 1 else
                [r * m + k for r in range(s, fused_step.CLUSTER)])
        static_ok[p, ties] = True
        taint[p, ties], aff[p, ties], img[p, ties], jitter[p, ties] = 0.0, 5.0, 17.0, 0.5
        want[p] = min(ties)
    static_ok[5] = False
    want[5] = -1
    nominated[9] = want[9] = n_real - 10
    static_ok[9, n_real - 10] = True
    ff = np.where(static_ok, 0, rng.randint(1, 5, size=(P, n)))
    return {
        "alloc": alloc, "requested": nz.copy(), "nonzero": nz,
        "ports": np.zeros((n, W), np.int32), "p_req": p_req, "p_nz": p_nz.astype(np.int32),
        "p_bits": np.zeros((P, W), np.int32), "static_ok": static_ok,
        "static_ff": ff.astype(np.int8), "taint": taint, "aff": aff, "img": img,
        "jitter": jitter.astype(np.float32), "nominated": nominated, "p_valid": valid,
    }, want


def _to_device(d: dict, device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in d.items()}


def _compare(got, want, label: str) -> float:
    """Raise unless every output is equal (floats by bit pattern); returns
    the largest absolute difference of the float outputs (0.0)."""
    err = 0.0
    for name, a, b in zip(got._fields, got, want):
        if a.dtype == torch.float32:
            err = max(err, float((a - b).abs().max()))
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"kernel != plain version on {label}: {name} ({bad} entries)")
    return err


def _bound(args: dict, out) -> tuple:
    """(bound_ms, bound_by, bytes): each input read once and each output written
    once over the memory rate (``fused_step.fused_step_bytes``, which must
    equal the tensors' own bytes), against the float32 work over its peak."""
    pods, n = args["static_ok"].shape
    nbytes = fused_step.fused_step_bytes(pods, n, args["alloc"].shape[1], args["ports"].shape[1])
    counted = sum(t.numel() * t.element_size() for t in (*args.values(), *out))
    if nbytes != counted:
        raise AssertionError(f"fused_step_bytes {nbytes} != the tensors' {counted} bytes")
    flops = pods * n * 40  # scores, normalization, total and argmax per (pod, node)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def kernel_phase(device) -> dict:
    weights = (1.0, 1.0, 3.0, 2.0, 1.0)
    cases = [(k, _to_device(_seeded_batch(k, s), device))
             for k, s in (("random", 1), ("boundary", 2), ("ties", 3), ("masked", 5))]
    slices, slices_want = _slices_batch(4)
    cases.append(("slices", _to_device(slices, device)))
    basic = scheduling_basic_args(device)
    cases.append(("scheduling-basic", basic))
    print(f"launch: {fused_step.CLUSTER} blocks x {fused_step._THREADS} threads, 1 cluster")
    err, winners = 0.0, {}
    for label, args in cases:
        got = fused_step.fused_step_batch(*args.values(), weights)
        torch.cuda.synchronize()
        winners[label] = got.node_idx.cpu().numpy()
        want = fused_step.fused_step_batch_ref(*args.values(), weights)
        err = max(err, _compare(got, want, label))
        placed = int((got.node_idx >= 0).sum())
        print(f"kernel == plain on {label}: {placed}/{P} placed, "
              f"first_fail ids {sorted(torch.unique(got.first_fail).tolist())}")
    if not (winners["masked"][[0, 7, 77]] == -1).all():
        raise AssertionError("masked batch: a pod with every node masked was placed")
    if not np.array_equal(winners["slices"], slices_want):
        raise AssertionError("slices batch: winners differ from the ones it was built for")
    m = -(-slices["alloc"].shape[0] // fused_step.CLUSTER)
    won = sorted({int(i) // m for i in winners["slices"] if i >= 0})
    if won != list(range(fused_step.CLUSTER)):
        raise AssertionError(f"slices batch: winners only in slices {won}")
    print(f"slices batch: winners in slices {won}, ties at every boundary k*{m}-1 / k*{m} "
          f"went to the smaller index")

    args = list(basic.values())
    times, out = _event_ms(lambda: fused_step.fused_step_batch(*args, weights))
    masked = dict(cases)["masked"]
    masked_times, _ = _event_ms(lambda: fused_step.fused_step_batch(*masked.values(), weights))
    plain = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_step.fused_step_batch_ref(*args, weights)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    bound_ms, bound_by, nbytes = _bound(basic, out)
    ms = statistics.median(times)
    print(f"fused_step_batch on a SchedulingBasic batch (N={args[0].shape[0]}, P={P}): "
          f"kernel median {ms:.4f} ms over {TIMED_LAUNCHES} launches "
          f"(min {min(times):.4f}, max {max(times):.4f}); plain PyTorch "
          f"{statistics.median(plain):.2f} ms; bound {bound_ms:.5f} ms "
          f"({nbytes} bytes, {bound_by})")
    masked_ms = statistics.median(masked_times)
    print(f"fused_step_batch on the masked batch: kernel median {masked_ms:.4f} ms over "
          f"{TIMED_LAUNCHES} launches (min {min(masked_times):.4f}, max {max(masked_times):.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": statistics.median(plain),
            "bound_ms": bound_ms, "bound_by": bound_by, "masked_ms": masked_ms}


def _event_ms(fn, warmup: int = 3) -> tuple:
    """CUDA-event ms of each of TIMED_LAUNCHES calls of ``fn`` after a
    warm-up, and the last call's result."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


# ---------------------------------------------------------------- the runner


@contextlib.contextmanager
def _spec_flag(value: str):
    """``KTPU_SPEC`` for the runs inside: "0" the fused kernel and the scan,
    "1" the speculative rounds in every mode, "auto" the port's default."""
    old = os.environ.get("KTPU_SPEC")
    os.environ["KTPU_SPEC"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KTPU_SPEC", None)
        else:
            os.environ["KTPU_SPEC"] = old


def _host_copy(obj, device="cpu"):
    """A copy on ``device`` of a schema dataclass, a BatchResult, or a list or
    dict of them (a copy on the host too: a later sync writes rows into the
    mirror)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_host_copy(v, device) for v in obj]
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _host_copy(getattr(obj, f.name), device)
                            for f in dataclasses.fields(obj)})
    return obj


class _Watch:
    """Stands in for ``batch_scheduler.schedule_batch`` during a run. On the
    card, a scan batch runs under ``set_sync_debug_mode("error")`` (any host
    read inside it raises) and a spec batch under "warn", its host reads
    counted against its rounds (``batch.ROUNDS``); the fused kernel's
    launches are counted per mode; batch ``profile_at`` runs under
    torch.profiler instead (the profiler itself synchronises); and the
    inputs and the result of batch ``capture_at`` are copied to the host."""

    def __init__(self, profile_at: int = -1, capture_at: int = -1):
        self.inner = batch_scheduler.schedule_batch
        self.calls = 0
        self.fused_launches = {"off": 0, "host": 0, "general": 0}
        self.spec = []  # (call, rounds, host reads) of each counted spec batch
        self.profile_at, self.capture_at = profile_at, capture_at
        self.profile = self.captured = None
        self.last_mode = None

    def __call__(self, *args, **kw):
        mode, spec = kw.get("topo_mode", "off"), kw.get("spec_decode", False)
        self.last_mode = mode
        on_card = torch.device(kw["device"]).type == "cuda"
        before, rounds0 = fused_step.LAUNCHES, batch.ROUNDS
        if self.calls == self.capture_at:
            self.captured = {"args": _host_copy(args), "kw": _host_copy(kw)}
        if on_card and self.calls == self.profile_at:
            self.profile = _profiled(self.inner, args, kw)
            self.profile["rounds"] = batch.ROUNDS - rounds0
            res = self.profile.pop("result")
        elif on_card and spec:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = self.inner(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            reads = sum("synchronizing" in str(w.message) for w in caught)
            self.spec.append((self.calls, batch.ROUNDS - rounds0, reads))
        elif on_card and mode != "off":
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = self.inner(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            res = self.inner(*args, **kw)
        if self.calls == self.capture_at:
            self.captured["result"] = _host_copy(res)  # before a later sync writes into it
        self.fused_launches[mode] += fused_step.LAUNCHES - before
        self.calls += 1
        return res


def _profiled(fn, args, kw) -> dict:
    """One batch under torch.profiler: its CUDA kernels, their device time
    and the wall time (synchronised before and after)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = fn(*args, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = busy_us = launches = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
            busy_us += getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    return {"result": res, "kernels": kernels, "launch_calls": launches,
            "device_ms": busy_us / 1e3, "wall_ms": wall_ms}


def _run(w, device, profile_at: int = -1, capture_at: int = -1) -> dict:
    """One workload through BatchScheduler: init pods, then the measured
    pods in batches of P, each timed on the host clock. The profiled batch
    is left out of the timings."""
    watch = _Watch(profile_at, capture_at)
    batch_scheduler.schedule_batch = watch
    try:
        store = w.store()  # claims, volumes and PodGroups, where the workload has them
        sched = BatchScheduler(w.node_infos(), caps=w.caps(), device=device, client=store)
        placed = sched.schedule(w.init_pod_list())
        init_batches = sched.batches
        measured = w.measured_pod_list()
        per_batch = []
        stage_ms = dict.fromkeys(sched.stage_seconds, 0.0)
        screen_ms = dict.fromkeys(sched.screen_seconds, 0.0)
        for i in range(0, len(measured), P):
            profiled = watch.calls == profile_at
            stages0, screens0 = dict(sched.stage_seconds), dict(sched.screen_seconds)
            t0 = time.perf_counter()
            placed.update(sched.schedule(measured[i:i + P]))  # ends in the host read
            if not profiled:
                per_batch.append(((time.perf_counter() - t0) * 1e3, len(measured[i:i + P])))
                for k, v in sched.stage_seconds.items():
                    stage_ms[k] += (v - stages0[k]) * 1e3
                for k, v in sched.screen_seconds.items():
                    screen_ms[k] += (v - screens0[k]) * 1e3
    finally:
        batch_scheduler.schedule_batch = watch.inner
    ms = [t for t, _ in per_batch]
    return {"placed": placed, "sched": sched, "per_batch": per_batch, "watch": watch,
            "modes": sched.batch_modes, "paths": sched.batch_paths, "store": store,
            "init_batches": init_batches, "median_ms": statistics.median(ms),
            "pods_per_s": sum(n for _, n in per_batch) / (sum(ms) / 1e3),
            "stage_ms": {k: v / len(per_batch) for k, v in stage_ms.items()},
            "screen_ms": {k: v / len(per_batch) for k, v in screen_ms.items()}}


def _check_placed(name: str, w, gpu: dict) -> None:
    placed = gpu["placed"]
    unplaced = [k for k, v in placed.items() if v is None]
    if len(placed) != w.n_init + w.n_measured or unplaced:
        raise AssertionError(f"{name}: {len(unplaced)} pods unplaced of {len(placed)}")


def _check_same(name: str, got: dict, want: dict, what: str) -> None:
    if got["placed"] != want["placed"]:
        diff = sum(want["placed"][key] != v for key, v in got["placed"].items())
        raise AssertionError(f"{name}: {diff} placements differ from {what}")
    if got["modes"] != want["modes"]:
        raise AssertionError(f"{name}: modes {got['modes']} != {what}'s {want['modes']}")


def _report(name: str, gpu: dict) -> None:
    ms = [t for t, _ in gpu["per_batch"]]
    paths = sorted(set(gpu["paths"]))
    print(f"{name} on cuda: {len(gpu['placed'])} pods placed in {len(gpu['modes'])} batches "
          f"(modes: init {gpu['modes'][0]}, measured {gpu['modes'][-1]}; paths {paths}), "
          f"fused-kernel launches by mode {gpu['watch'].fused_launches}; measured phase "
          f"{gpu['pods_per_s']:.1f} pods/s, median {gpu['median_ms']:.2f} ms per batch (min "
          f"{min(ms):.2f}, max {max(ms):.2f}; {len(ms)} batches of up to {P}, the profiled one "
          f"left out); host ms per measured batch by stage: "
          + ", ".join(f"{k} {v:.2f}" for k, v in gpu["stage_ms"].items()))
    prof = gpu["watch"].profile
    if prof is not None:
        print(f"{name} one measured batch under torch.profiler: {prof['kernels']} CUDA kernels "
              f"({prof['kernels'] / P:.1f} per pod), {prof['launch_calls']} kernel-launch "
              f"calls, device busy {prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} ms wall")


# ---------------------------------------------------------------- slice phase


def slice_phase() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    fused_step.LAUNCHES = 0
    gpu = _run(basic, "cuda", profile_at=basic.init_pods // P + 2)
    launches = fused_step.LAUNCHES
    _check_placed(basic.name, basic, gpu)
    if set(gpu["paths"]) != {"fused"}:
        raise AssertionError(f"{basic.name}: paths {gpu['paths']} under KTPU_SPEC=auto")
    if launches != gpu["sched"].batches:
        raise AssertionError(f"{launches} kernel launches for {gpu['sched'].batches} batches")
    cpu = _run(basic, "cpu")
    _check_same(basic.name, gpu, cpu, "the cpu run")
    print(f"{basic.name}: kernel launches {launches} (one per batch), placements == cpu run")
    _report(basic.name, gpu)
    return {"launches": launches, "workload": basic, "gpu": gpu, "cpu": cpu}


# ---------------------------------------------------------------- topology phase


def _check_topo(name: str, w, gpu: dict, cpu: dict, init_mode: str, meas_mode: str) -> None:
    _check_placed(name, w, gpu)
    modes, k = gpu["modes"], gpu["init_batches"]
    if set(modes[:k]) != {init_mode} or set(modes[k:]) != {meas_mode}:
        raise AssertionError(f"{name}: batch modes {modes}")
    watch = gpu["watch"]
    if watch.fused_launches["host"] or watch.fused_launches["general"]:
        raise AssertionError(f"{name}: the fused kernel launched in topology batches: "
                             f"{watch.fused_launches}")
    if watch.profile is None:
        raise AssertionError(f"{name}: no topology batch was profiled")
    _check_same(name, gpu, cpu, "the cpu run")


def topology_phase() -> dict:
    sizes = 8195
    on_card = topology.size_log_table(sizes, "cuda").cpu()
    on_host = topology.size_log_table(sizes, "cpu")
    if not torch.equal(on_card.view(torch.int32), on_host.view(torch.int32)):
        raise AssertionError("size_log_table differs between cuda and cpu")
    x = torch.arange(sizes, dtype=torch.float32) + 2.0
    plain_card = torch.log(x.cuda()).cpu()
    times, _ = _event_ms(lambda: topology.size_log_table(sizes, "cuda"))
    prof = _profiled(topology.size_log_table, (sizes, "cuda"), {})
    print(f"size_log_table over sizes 0..{sizes - 1}: cuda == cpu bit for bit; torch.log: "
          f"cuda differs from cpu at {int((plain_card != torch.log(x)).sum())} sizes and from "
          f"the table at {int((plain_card != on_card).sum())}; built once per topology batch "
          f"in {statistics.median(times):.4f} ms on the card (median of {TIMED_LAUNCHES} "
          f"CUDA-event timings), {prof['launch_calls']} kernel launches ({prof['kernels']} "
          f"device records)")

    out = {}
    with _spec_flag("0"):  # the scan; the spec phase runs the rounds
        anti = workloads.scheduling_pod_anti_affinity()
        gpu = _run(anti, "cuda", profile_at=10)
        cpu = _run(anti, "cpu")
        _check_topo(anti.name, anti, gpu, cpu, "host", "host")
        nodes = [v for v in gpu["placed"].values()]
        if len(set(nodes)) != len(nodes):
            raise AssertionError(f"{anti.name}: {len(nodes) - len(set(nodes))} pods share a node")
        print(f"{anti.name}: placements == cpu run, no host sync in the scan batches' "
              f"device calls")
        _report(anti.name, gpu)
        out[anti.name] = {"workload": anti, "gpu": gpu, "cpu": cpu}

        spread = workloads.topology_spreading()
        gpu = _run(spread, "cuda", profile_at=spread.init_pods // P + 2)
        cpu = _run(spread, "cpu")
        _check_topo(spread.name, spread, gpu, cpu, "off", "general")
        zone_of = {ni.node.meta.name: ni.node.meta.labels["topology.kubernetes.io/zone"]
                   for ni in gpu["sched"].snapshot.node_info_map.values()}
        per_zone = {}
        for key, node in gpu["placed"].items():
            if key.startswith("default/spread-"):
                per_zone[zone_of[node]] = per_zone.get(zone_of[node], 0) + 1
        if len(per_zone) != 10 or max(per_zone.values()) - min(per_zone.values()) > 1:
            raise AssertionError(f"{spread.name}: spread pods per zone {per_zone}")
        print(f"{spread.name}: measured pods per zone {sorted(per_zone.values())}; "
              f"placements == cpu run, no host sync in the scan batches' device calls")
        _report(spread.name, gpu)
        out[spread.name] = {"workload": spread, "gpu": gpu, "cpu": cpu}
    return out


# ---------------------------------------------------------------- spec phase


def _compare_results(name: str, got, want) -> None:
    """Every field of two BatchResults equal, floats by bit pattern."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        pairs = ([(f"{f.name}.{k}", a[k], b[k]) for k in sorted(a)] if isinstance(a, dict)
                 else [(f.name, a, b)])
        for label, x, y in pairs:
            if (x is None) != (y is None):
                raise AssertionError(f"{name}: {label} is None on one device only")
            if x is None:
                continue
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"{name}: spec {label} differs between cuda and cpu")


def _ab(cap: dict, reps: int) -> dict:
    """The rounds and the path they replace on one captured batch's inputs,
    on the card, in turns (other, spec, spec, other) ``reps`` times: median
    ms from the call to the end of the packed block's host read."""
    args = _host_copy(cap["args"], "cuda")
    kw = {**_host_copy(cap["kw"], "cuda"), "device": "cuda"}
    times = {True: [], False: []}
    for _ in range(reps):
        for spec in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batch.schedule_batch(*args, **{**kw, "spec_decode": spec})
            res.packed.cpu()
            times[spec].append((time.perf_counter() - t0) * 1e3)
    return {"spec": statistics.median(times[True]), "other": statistics.median(times[False])}


def spec_phase(basic: dict, topo: dict) -> dict:
    """Every batch of the three workloads forced to the speculative rounds
    on the card, against the earlier phases' runs of the fused kernel and
    the scan (cuda) and of the plain versions (cpu)."""
    rows = {}
    with _spec_flag("1"):
        for prev in (basic, *topo.values()):
            w = prev["workload"]
            profile_at = w.init_pods // P + 2
            gpu = _run(w, "cuda", profile_at=profile_at, capture_at=profile_at + 1)
            _check_placed(w.name, w, gpu)
            if set(gpu["paths"]) != {"spec"} or any(gpu["watch"].fused_launches.values()):
                raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, fused launches "
                                     f"{gpu['watch'].fused_launches} with the rounds forced")
            _check_same(w.name, gpu, prev["cpu"], "the cpu run")
            _check_same(w.name, gpu, prev["gpu"], "the cuda run of the kernel or the scan")
            counted = gpu["watch"].spec
            bad = [(c, r, n) for c, r, n in counted if n != r or r < 1]
            if bad or len(counted) != len(gpu["modes"]) - 1:
                raise AssertionError(f"{w.name}: host reads != rounds in (call, rounds, reads) "
                                     f"{bad[:5]} of {len(counted)} counted batches")
            cap = gpu["watch"].captured
            want = batch.schedule_batch(*cap["args"], **{**cap["kw"], "device": "cpu"})
            _compare_results(w.name, cap["result"], want)
            rounds = [r for c, r, _ in counted if c >= gpu["init_batches"]]
            prof = gpu["watch"].profile
            old = prev["gpu"]
            print(f"{w.name} spec rounds on cuda: placements == cpu run and == the cuda run of "
                  f"{sorted(set(old['paths']))}; host reads == rounds in all {len(counted)} "
                  f"counted batches; batch {profile_at + 1} ({gpu['modes'][profile_at + 1]}): "
                  f"spec BatchResult cuda == cpu on every field")
            _report(w.name, gpu)
            print(f"{w.name} measured batches: rounds per batch median "
                  f"{statistics.median(rounds)} (min {min(rounds)}, max {max(rounds)}, mean "
                  f"{statistics.mean(rounds):.2f}); host reads per batch = rounds; profiled batch: "
                  f"{prof['rounds']} rounds, {prof['kernels']} CUDA kernels, "
                  f"{prof['kernels'] / max(prof['rounds'], 1):.1f} per round, device busy "
                  f"{prof['device_ms']:.2f} ms. Replaced path {sorted(set(old['paths'][-1:]))}: "
                  f"{old['pods_per_s']:.1f} pods/s, median {old['median_ms']:.2f} ms per batch, "
                  f"{old['watch'].profile['kernels']} CUDA kernels and device busy "
                  f"{old['watch'].profile['device_ms']:.2f} ms in its profiled batch")
            ab = _ab(cap, 3 if gpu["modes"][-1] == "off" else 1)
            rows[w.name] = {"mode": gpu["modes"][-1], "other": old["paths"][-1], "ab": ab,
                            "e2e": {"spec": gpu["median_ms"], "other": old["median_ms"]},
                            "pods_per_s": {"spec": gpu["pods_per_s"],
                                           "other": old["pods_per_s"]}}
    print("KTPU_SPEC=auto on cuda against this run: the commit paths in turns on one measured "
          "batch (ms from the call to the packed block on the host), and the median ms per "
          "measured batch end to end:")
    for name, r in rows.items():
        ab, e2e, other = r["ab"], r["e2e"], r["other"]
        faster = ab["spec"] < ab["other"]
        table = batch.SPEC_AUTO_CUDA[r["mode"]]
        ratio = max(ab.values()) / min(ab.values())
        print(f"  mode {r['mode']} ({name}): in turns spec {ab['spec']:.2f} ms, {other} "
              f"{ab['other']:.2f} ms, faster: {'spec' if faster else other} by {ratio:.2f}x; "
              f"end to end spec {e2e['spec']:.2f} ms, {other} {e2e['other']:.2f} ms; "
              f"SPEC_AUTO_CUDA takes {'spec' if table else other}")
        if table != faster and ratio > 1.5:
            raise AssertionError(f"SPEC_AUTO_CUDA[{r['mode']!r}] takes the slower path")
    return rows


# ---------------------------------------------------------------- DRA phase


def _allocations(run: dict) -> dict:
    store = run["store"]
    return {k: (c.allocated_node, c.reserved_for) for k, c in store.resource_claims.items()}


def _check_masked(name: str, w, run: dict, what: str) -> None:
    _check_placed(name, w, run)
    sched = run["sched"]
    if sched.retry or sched.fallback:
        raise AssertionError(f"{name} ({what}): retry {dict(list(sched.retry.items())[:3])}, "
                             f"fallback {dict(list(sched.fallback.items())[:3])}")


class _MaskWatch:
    """Stands in for ``claim_mask.claim_feasibility_mask`` during a run:
    copies call ``capture_at``'s inputs and result to the host."""

    def __init__(self, capture_at: int):
        self.inner = claim_mask.claim_feasibility_mask
        self.calls, self.capture_at, self.captured = 0, capture_at, None

    def __call__(self, *args):
        out = self.inner(*args)
        if self.calls == self.capture_at:
            self.captured = (_host_copy(list(args)), _host_copy(out))
        self.calls += 1
        return out


def dra_phase() -> dict:
    """SchedulingDRA and SchedulingInTreePVs on the card (auto: the fused
    kernel), on the CPU and on the card with the rounds forced."""
    out = {}
    for w in (workloads.scheduling_dra(), workloads.scheduling_intree_pvs()):
        k = w.init_pods // P + 1  # the first measured batch but one is profiled
        mask_watch = _MaskWatch(capture_at=k if w.measured.claim else -1)
        claim_mask.claim_feasibility_mask = mask_watch
        try:
            fused_step.LAUNCHES = 0
            gpu = _run(w, "cuda", profile_at=k + 1, capture_at=k)
            launches = fused_step.LAUNCHES
        finally:
            claim_mask.claim_feasibility_mask = mask_watch.inner
        _check_masked(w.name, w, gpu, "cuda")
        if set(gpu["paths"]) != {"fused"} or launches != gpu["sched"].batches:
            raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, {launches} kernel "
                                 f"launches for {gpu['sched'].batches} batches")
        cpu = _run(w, "cpu", capture_at=k)
        _check_masked(w.name, w, cpu, "cpu")
        _check_same(w.name, gpu, cpu, "the cpu run")
        if _allocations(gpu) != _allocations(cpu):
            raise AssertionError(f"{w.name}: claim allocations differ from the cpu run")
        masks = [m for m in ("extra_mask", "dra_mask") if gpu["watch"].captured["kw"].get(m)
                 is not None]
        for m in masks:
            a, b = gpu["watch"].captured["kw"][m], cpu["watch"].captured["kw"][m]
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{w.name}: batch {k}'s {m} differs between cuda and cpu")
        with _spec_flag("1"):
            spec = _run(w, "cuda")
        _check_masked(w.name, w, spec, "spec")
        if set(spec["paths"]) != {"spec"}:
            raise AssertionError(f"{w.name}: paths {set(spec['paths'])} with the rounds forced")
        _check_same(w.name, spec, gpu, "the cuda run of the kernel")
        if _allocations(spec) != _allocations(gpu):
            raise AssertionError(f"{w.name}: claim allocations of the rounds differ")
        row = {"workload": w, "gpu": gpu, "launches": launches}
        line = (f"{w.name}: every pod placed, retry and fallback empty; {launches} kernel "
                f"launches for {gpu['sched'].batches} batches; placements == cpu run == the "
                f"rounds on cuda; batch {k}'s {' and '.join(masks)} cuda == cpu bit for bit")
        if w.measured.claim:
            gen = {ni.node.meta.name: ni.node.status.device_attributes.get("tpu.dev/gen")
                   for ni in gpu["sched"].snapshot.node_info_map.values()}
            allocs = _allocations(gpu)
            for key, node in gpu["placed"].items():
                claim = allocs[f"{key}-{w.measured.claim.name}"]
                if gen[node] != "v5" or claim != (node, (key,)):
                    raise AssertionError(f"{w.name}: {key} on {node} (gen {gen[node]}), "
                                         f"claim {claim}")
            args, want = mask_watch.captured
            args = _host_copy(args, "cuda")
            got = claim_mask.claim_feasibility_mask(*args).cpu()
            if not torch.equal(got, want) or not torch.equal(
                    claim_mask.claim_feasibility_mask(*_host_copy(args)), want):
                raise AssertionError(f"{w.name}: the claim mask differs from its capture")
            times, _ = _event_ms(lambda: claim_mask.claim_feasibility_mask(*args))
            prof = _profiled(claim_mask.claim_feasibility_mask, args, {})
            row["claim_mask_ms"] = statistics.median(times)
            line += (f"; every claim pod on a gen v5 node with its claim allocated there; "
                     f"claim_feasibility_mask [P={args[0].shape[0]}, S={args[0].shape[1]}, "
                     f"N={args[4].shape[0]}, A={args[4].shape[1]}] on the card: median "
                     f"{row['claim_mask_ms']:.4f} ms over {TIMED_LAUNCHES} (CUDA events; min "
                     f"{min(times):.4f}, max {max(times):.4f}), {prof['kernels']} CUDA kernels, "
                     f"device busy {prof['device_ms']:.4f} ms")
        print(line)
        _report(w.name, gpu)
        print(f"{w.name} host ms per measured batch inside the stages: " + ", ".join(
            f"{k2} {v:.3f}" for k2, v in gpu["screen_ms"].items()) + "; rounds forced: "
            f"{spec['pods_per_s']:.1f} pods/s, median {spec['median_ms']:.2f} ms per batch")
        out[w.name] = row
    return out


# ---------------------------------------------------------------- preempt phase


class _ScreenWatch:
    """Stands in for ``batch_scheduler.screen_prefix`` during a run: copies
    to the host the inputs and result of the call with the most failed
    pods (the first of them)."""

    def __init__(self):
        self.inner = batch_scheduler.screen_prefix
        self.calls = 0
        self.captured = None

    def __call__(self, pb, nt, static_masks, failed_prefix):
        out = self.inner(pb, nt, static_masks, failed_prefix)
        rows = int(np.sum(failed_prefix))
        if self.captured is None or rows > self.captured["rows"]:
            self.captured = {"rows": rows, "failed": np.array(failed_prefix, bool),
                             "args": _host_copy([pb, nt, static_masks]),
                             "result": _host_copy(list(out))}
        self.calls += 1
        return out


def _run_preempt(w, device) -> dict:
    """One preemption workload through BatchScheduler and
    ``run_with_preemption``, every batch timed on the host clock with its
    stage and screen seconds."""
    watch, screens = _Watch(), _ScreenWatch()
    batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = watch, screens
    try:
        sched = BatchScheduler(w.node_infos(), device=device, client=w.store())
        records = []
        inner = sched._schedule_batch

        def timed(pods):
            s0, c0 = dict(sched.stage_seconds), dict(sched.screen_seconds)
            t0 = time.perf_counter()
            out = inner(pods)
            records.append({
                "ms": (time.perf_counter() - t0) * 1e3, "pods": len(pods),
                "failed": sum(v is None for v in out.values()),
                "stages": {k: (v - s0[k]) * 1e3 for k, v in sched.stage_seconds.items()},
                "screens": {k: (v - c0[k]) * 1e3 for k, v in sched.screen_seconds.items()}})
            return out

        sched._schedule_batch = timed
        t0 = time.perf_counter()
        placed, rounds = workloads.run_with_preemption(sched, w)
        wall_s = time.perf_counter() - t0
    finally:
        batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = (watch.inner,
                                                                          screens.inner)
    return {"placed": placed, "rounds": rounds, "preempted": dict(sched.preempted),
            "sched": sched, "watch": watch, "screens": screens, "records": records,
            "wall_s": wall_s, "paths": sched.batch_paths}


def _check_preempt(name: str, w, run: dict, what: str) -> None:
    sched, placed = run["sched"], run["placed"]
    preemptors = [k for k in placed if k.startswith(("default/warm-", "default/preemptor-"))]
    unbound = [k for k in preemptors if placed[k] is None]
    if len(preemptors) != w.warm_pods + w.measured_pods or unbound or sched.nominated:
        raise AssertionError(f"{name} ({what}): {len(unbound)} of {len(preemptors)} preemptors "
                             f"unbound after {len(run['rounds'])} rounds, "
                             f"{len(sched.nominated)} still nominated")
    if sched.retry or sched.fallback:
        raise AssertionError(f"{name} ({what}): retry {sched.retry}, fallback {sched.fallback}")
    for ni in sched.snapshot.node_info_map.values():
        if (ni.requested.milli_cpu > ni.allocatable.milli_cpu
                or ni.requested.memory > ni.allocatable.memory
                or len(ni.pods) > ni.allocatable.allowed_pod_number):
            raise AssertionError(f"{name} ({what}): {ni.node.meta.name} over its allocatable")
    evicted = set(run["preempted"])
    if any(p.key() in evicted for ni in sched.snapshot.node_info_map.values() for p in ni.pods):
        raise AssertionError(f"{name} ({what}): a victim is still on its node")


def _check_preempt_same(name: str, got: dict, want: dict, what: str) -> None:
    for key in ("placed", "rounds", "preempted"):
        if got[key] != want[key]:
            raise AssertionError(f"{name}: {key} differ from {what}")


def _screen_on_card(name: str, cap: dict) -> dict:
    """The captured failing batch's screen: the card's result against the
    CPU's on the same inputs, one call under set_sync_debug_mode("error"),
    CUDA-event ms and the profile."""
    pb, nt, masks = cap["args"]
    rows = np.flatnonzero(cap["failed"]).tolist()
    want = preempt.screen_prefix(pb, nt, masks, cap["failed"])
    for label, a, b in (("screen", cap["result"][0], want.screen),
                        ("best", cap["result"][1], want.best)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: the screen's {label} differs between cuda and cpu")
    args = _host_copy([pb, nt, masks], "cuda") + [rows]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = preempt.preempt_screen(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (torch.equal(got.screen.cpu(), want.screen) and torch.equal(got.best.cpu(), want.best)):
        raise AssertionError(f"{name}: the screen on the card differs from its capture")
    times, _ = _event_ms(lambda: preempt.preempt_screen(*args))
    prof = _profiled(preempt.preempt_screen, args, {})
    n, c, _r = nt.class_req.shape
    return {"ms": statistics.median(times), "min": min(times), "max": max(times),
            "kernels": prof["kernels"], "device_ms": prof["device_ms"],
            "wall_ms": prof["wall_ms"], "launch_calls": prof["launch_calls"],
            "shape": f"[P={pb.capacity}, N={n}, C={c}], {len(rows)} failed rows"}


def preempt_phase() -> dict:
    """PreemptionBasic and PreemptionPVs on the card (auto: the fused
    kernel), on the CPU and on the card with the rounds forced."""
    out = {}
    for w in (workloads.preemption_basic(), workloads.preemption_pvs()):
        fused_step.LAUNCHES = 0
        gpu = _run_preempt(w, "cuda")
        launches = fused_step.LAUNCHES
        _check_preempt(w.name, w, gpu, "cuda")
        if set(gpu["paths"]) != {"fused"} or launches != gpu["sched"].batches:
            raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, {launches} kernel "
                                 f"launches for {gpu['sched'].batches} batches")
        cpu = _run_preempt(w, "cpu")
        _check_preempt(w.name, w, cpu, "cpu")
        _check_preempt_same(w.name, gpu, cpu, "the cpu run")
        with _spec_flag("1"):
            spec = _run_preempt(w, "cuda")
        _check_preempt(w.name, w, spec, "spec")
        if set(spec["paths"]) != {"spec"}:
            raise AssertionError(f"{w.name}: paths {set(spec['paths'])} with the rounds forced")
        _check_preempt_same(w.name, spec, gpu, "the cuda run of the kernel")
        screen = _screen_on_card(w.name, gpu["screens"].captured)
        init_batches = -(-w.init_pods // P)
        recs = gpu["records"][init_batches:]  # warm, measured and resubmitted batches
        failing = [r for r in recs if r["failed"]]
        stages = {k: statistics.median(r["stages"][k] for r in recs) for k in recs[0]["stages"]}
        med = lambda rs, key: statistics.median(r["screens"][key] for r in rs)  # noqa: E731
        per_pod = [r["screens"]["preempt_host"] / r["failed"] for r in failing]
        print(f"{w.name}: all {w.warm_pods + w.measured_pods} preemptors bound in "
              f"{len(gpu['rounds'])} resubmission rounds (nominated before each: "
              f"{[len(r) for r in gpu['rounds']]}), {len(gpu['preempted'])} victims; placements, "
              f"nominations and victims == cpu run == the rounds on cuda; {launches} kernel "
              f"launches for {gpu['sched'].batches} batches; every node within its allocatable")
        print(f"{w.name} on cuda: {len(recs)} batches after the init pods, median "
              f"{statistics.median(r['ms'] for r in recs):.2f} ms (min "
              f"{min(r['ms'] for r in recs):.2f}, max {max(r['ms'] for r in recs):.2f}); "
              f"median host ms by stage: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
              + f"; {len(failing)} failing batches: median {statistics.median(r['ms'] for r in failing):.2f} "
              f"ms, failed pods {[r['failed'] for r in failing]}, screen with its read "
              f"{med(failing, 'preempt_screen'):.2f} ms, host Evaluator "
              f"{med(failing, 'preempt_host'):.2f} ms (per failed pod median "
              f"{statistics.median(per_pod):.3f}, max {max(per_pod):.3f}; per batch "
              f"{[round(r['screens']['preempt_host'], 1) for r in failing]}); whole run "
              f"{gpu['wall_s']:.2f} s, cpu {cpu['wall_s']:.2f} s, rounds forced "
              f"{spec['wall_s']:.2f} s")
        print(f"{w.name} preempt_screen on the failing batch {screen['shape']}: cuda == cpu "
              f"exactly, no host read under set_sync_debug_mode(\"error\"); median "
              f"{screen['ms']:.4f} ms over {TIMED_LAUNCHES} (CUDA events; min {screen['min']:.4f}, "
              f"max {screen['max']:.4f}); {screen['kernels']} CUDA kernels, "
              f"{screen['launch_calls']} kernel-launch calls, device busy "
              f"{screen['device_ms']:.4f} ms of {screen['wall_ms']:.2f} ms wall")
        out[w.name] = {"launches": launches, "screen": screen,
                       "median_ms": statistics.median(r["ms"] for r in recs)}
    return out


# ---------------------------------------------------------------- gang phase


class _VerdictWatch:
    """Stands in for ``batch_scheduler.gang_verdicts`` during a run: copies
    call ``capture_at``'s inputs and outputs to the host."""

    def __init__(self, capture_at: int):
        self.inner = batch_scheduler.gang_verdicts
        self.calls, self.capture_at, self.captured = 0, capture_at, None

    def __call__(self, *args):
        out = self.inner(*args)
        if self.calls == self.capture_at:
            self.captured = (_host_copy(list(args)), _host_copy(list(out)))
        self.calls += 1
        return out


def _no_host_read(fn, *args):
    """``fn(*args)`` on the card under set_sync_debug_mode("error")."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _check_gangs(name: str, w, run: dict, what: str) -> None:
    """Every pod placed, nothing rejected or turned away; each gang whole
    (flat gangs on distinct hosts, slice gangs contiguous)."""
    _check_placed(name, w, run)
    sched = run["sched"]
    if sched.gang_rejected or sched.retry or sched.fallback:
        raise AssertionError(f"{name} ({what}): gang_rejected {dict(list(sched.gang_rejected.items())[:3])}, "
                             f"retry {sched.retry}, fallback {sched.fallback}")
    hosts = {}
    for ni in sched.snapshot.node_info_map.values():
        for p in ni.pods:
            hosts.setdefault(p.meta.labels["scheduling.x-k8s.io/pod-group"], []).append(
                ni.node.meta.name)
    if any(len(set(v)) != len(v) for v in hosts.values()):
        raise AssertionError(f"{name} ({what}): a gang has two members on one host")
    if w.tpu_slots:
        stats = workloads.slice_stats(sched.snapshot.node_info_map.values())
        if stats["ContiguityViolations"] or stats["BoundSliceGangs"] != len(hosts):
            raise AssertionError(f"{name} ({what}): slice stats {stats}")
        run["slice_stats"] = stats


def _reject_case(device) -> dict:
    """A 128-host torus (2 superpods of 64, hostname and zone labels): a
    gang of 8 anti-affine members whose node selector leaves 6 hosts, then
    a slice gang of 65 hosts, then 3 plain pods. Both gangs must be
    rejected whole ("infeasible"), the plain pods placed, and after the
    next sync the device's requested must equal a fresh encode."""
    from kubernetes_tpu_torch.api.types import LabelSelector, ObjectMeta, PodGroup
    from kubernetes_tpu_torch.api.wrappers import make_pod
    from kubernetes_tpu_torch.apiserver.store import Store

    infos = workloads.scheduling_basic_nodes(128, 10, capacity={"cpu": "4", "memory": "16Gi",
                                                                "pods": 8}, tpu_slots=64)
    for ni in infos[10:16]:
        ni.node.meta.labels["rack"] = "r0"
    store = Store()
    for name, k in (("flat", 8), ("wide", 65)):
        store.create_object("PodGroup", PodGroup(meta=ObjectMeta(name=name, namespace="default"),
                                                 min_member=k))
    flat = [make_pod(f"flat-{j}").req({"cpu": "500m", "memory": "1Gi"}).pod_group("flat")
            .node_selector({"rack": "r0"}).pod_affinity(
                "kubernetes.io/hostname",
                LabelSelector(match_labels={"scheduling.x-k8s.io/pod-group": "flat"}),
                anti=True).obj() for j in range(8)]
    wide = [make_pod(f"wide-{j}").req({"cpu": "3500m", "memory": "12Gi"}).pod_group("wide")
            .label("ktpu.dev/slice", "1").obj() for j in range(65)]
    plain = [make_pod(f"plain-{j}").req({"cpu": "250m", "memory": "1Gi"}).obj() for j in range(3)]
    sched = BatchScheduler(infos, caps=workloads.scheduling_slices(128).caps(), device=device,
                           client=store)
    placed = {}
    for pods in (flat, wide, plain):
        placed.update(sched.schedule(pods))
    want = dict.fromkeys((p.key() for p in flat + wide), "infeasible")
    if sched.gang_rejected != want or any(placed[p.key()] for p in flat + wide) or not all(
            placed[p.key()] for p in plain):
        raise AssertionError(f"reject case on {device}: gang_rejected "
                             f"{sorted(set(sched.gang_rejected.values()))}, placed {placed}")
    sched.state.sync(sched.snapshot)
    fresh = DeviceState(sched.caps, "cpu")
    fresh.sync(sched.snapshot)
    if not torch.equal(sched.state.nt.requested.cpu(), fresh.nt.requested):
        raise AssertionError(f"reject case on {device}: requested after the sync != a fresh encode")
    status = {k: (g.phase, g.scheduled) for k, g in store.pod_groups.items()}
    return {"placed": placed, "status": status, "modes": sched.batch_modes,
            "rejections": dict(sched.coscheduling.rejections)}


def _fused_inputs(args, kw, slice_mask):
    """The fused kernel's inputs for a captured batch, as
    ``schedule_batch_core`` builds them, with or without its slice mask."""
    pb, et, nt = args[:3]
    (_m, static_ok, static_ff, taint_raw, affinity_raw, image_score,
     jitter) = batch.static_phase(pb, et, nt, slice_mask=slice_mask)
    pod_bits = batch._pod_port_bits(pb, nt.port_bits.shape[1])
    return [nt.allocatable, nt.requested, nt.nonzero_requested, nt.port_bits, pb.req,
            pb.nonzero_req, pod_bits, static_ok.contiguous(), static_ff.contiguous(),
            taint_raw.contiguous(), affinity_raw.contiguous(), image_score.contiguous(),
            jitter.contiguous(), pb.nominated, pb.valid,
            batch.weight_vector({**batch.DEFAULT_WEIGHTS, **(args[3] or {})})]


def gang_phase() -> dict:
    """SchedulingGangs and SchedulingSlices on the card (auto), on the CPU
    and on the card with the other path forced; the plan and the verdicts
    on the card against the CPU; the reject case."""
    out = {}
    for w, other in ((workloads.scheduling_gangs(), "0"), (workloads.scheduling_slices(), "1")):
        k = -(-w.n_init // P)  # the first measured batch is captured
        slices = bool(w.tpu_slots)
        verdicts = _VerdictWatch(capture_at=-1 if slices else k)
        batch_scheduler.gang_verdicts = verdicts
        try:
            fused_step.LAUNCHES = 0
            gpu = _run(w, "cuda", profile_at=-1 if slices else k + 1, capture_at=k)
            launches = fused_step.LAUNCHES
        finally:
            batch_scheduler.gang_verdicts = verdicts.inner
        _check_gangs(w.name, w, gpu, "cuda")
        want_paths = {"fused"} if slices else {"spec"}
        if set(gpu["paths"]) != want_paths or launches != (gpu["sched"].batches if slices else 0):
            raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, {launches} kernel "
                                 f"launches for {gpu['sched'].batches} batches")
        cpu = _run(w, "cpu")
        _check_gangs(w.name, w, cpu, "cpu")
        _check_same(w.name, gpu, cpu, "the cpu run")
        with _spec_flag(other):
            forced = _run(w, "cuda")
        _check_gangs(w.name, w, forced, "forced")
        _check_same(w.name, forced, gpu, "the cuda run under auto")
        row = {"launches": launches, "gpu": gpu, "workload": w}
        cap = gpu["watch"].captured
        if slices:
            pb, nt = cap["args"][0], cap["args"][2]
            members, grid = cap["kw"]["slice_members"], cap["kw"]["slice_grid"]
            want = batch._slice_plan(pb, nt, members, grid)
            dev = _host_copy([pb, nt, members], "cuda")
            plan_args = (dev[0], dev[1], tuple(dev[2]), grid)
            got = _no_host_read(batch._slice_plan, *plan_args)
            words = batch.unpack_result_block(cap["result"].packed, w.caps().nodes)[2]
            if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)) or not np.array_equal(
                    words, want[1].numpy()):
                raise AssertionError(f"{w.name}: the slice plan differs between cuda and cpu")
            times, _ = _event_ms(lambda: batch._slice_plan(*plan_args))
            prof = _profiled(batch._slice_plan, plan_args, {})
            fargs = _host_copy(cap["args"], "cuda")
            fkw = _host_copy(cap["kw"], "cuda")
            masked = _fused_inputs(fargs, fkw, got[0])
            plain = _fused_inputs(fargs, fkw, None)
            kernel = {}
            for label in ("plain", "masked", "masked", "plain"):
                t, _ = _event_ms(lambda: fused_step.fused_step_batch(
                    *(masked if label == "masked" else plain)))
                kernel.setdefault(label, []).extend(t)
            row.update(plan_ms=statistics.median(times), plan_kernels=prof["kernels"],
                       plan_device_ms=prof["device_ms"],
                       masked_ms=statistics.median(kernel["masked"]),
                       plain_ms=statistics.median(kernel["plain"]))
            detail = (f"batch {k}'s slice plan [G={members[0].shape[0]}, M={members[0].shape[1]}, "
                      f"grid {grid[0]}x{grid[1]}, N={nt.capacity}] cuda == cpu bit for bit (mask, "
                      f"words, and the packed block's slice column), no host read; "
                      f"_slice_plan on the card: median {row['plan_ms']:.4f} ms over "
                      f"{TIMED_LAUNCHES} (CUDA events; min {min(times):.4f}, max {max(times):.4f}), "
                      f"{prof['kernels']} CUDA kernels, device busy {prof['device_ms']:.4f} ms; "
                      f"the fused kernel on this batch (N={nt.capacity}, P={P}) in turns: "
                      f"slice-masked {row['masked_ms']:.4f} ms, unmasked {row['plain_ms']:.4f} ms "
                      f"(median of {2 * TIMED_LAUNCHES} each); slice stats {gpu['slice_stats']}")
        else:
            args, outs = verdicts.captured
            want = batch.gang_verdicts(*args)
            dev = _host_copy(args, "cuda")
            got = _no_host_read(batch.gang_verdicts, *dev)
            if not all(torch.equal(a.cpu(), b) and torch.equal(b, c)
                       for a, b, c in zip(got, want, outs)):
                raise AssertionError(f"{w.name}: gang_verdicts differ between cuda and cpu")
            times, _ = _event_ms(lambda: batch.gang_verdicts(*dev))
            prof = _profiled(batch.gang_verdicts, dev, {})
            row.update(verdicts_ms=statistics.median(times), verdicts_kernels=prof["kernels"],
                       verdicts_device_ms=prof["device_ms"])
            detail = (f"batch {k}'s gang_verdicts [G={args[2].shape[0]}, M={args[2].shape[1]}, "
                      f"N={args[1].shape[1]}] from the card's batch result: cuda == cpu == the "
                      f"run's own, no host read; on the card: median {row['verdicts_ms']:.4f} ms "
                      f"over {TIMED_LAUNCHES} (CUDA events; min {min(times):.4f}, max "
                      f"{max(times):.4f}), {prof['kernels']} CUDA kernels, device busy "
                      f"{prof['device_ms']:.4f} ms")
        # the path auto takes against the other, in turns on the captured batch
        ab = _ab(cap, 1)
        mode = gpu["modes"][k]
        table = "spec" if batch.SPEC_AUTO_CUDA[mode] else "other"
        ratio = ab[table] / ab["other" if table == "spec" else "spec"]
        if ratio > 1.5:
            raise AssertionError(f"{w.name}: SPEC_AUTO_CUDA[{mode!r}] takes the path measured "
                                 f"{ratio:.2f}x slower in turns ({ab})")
        row["ab"] = ab
        print(f"{w.name}: every gang bound whole, gang_rejected, retry and fallback empty, "
              f"placements == cpu run == cuda with KTPU_SPEC={other}; paths {sorted(want_paths)}, "
              f"{launches} kernel launches for {gpu['sched'].batches} batches; {detail}; in turns "
              f"on batch {k} (mode {mode}): rounds {ab['spec']:.2f} ms, "
              f"{'fused kernel' if mode == 'off' else 'scan'} {ab['other']:.2f} ms, auto takes "
              f"{'the rounds' if table == 'spec' else 'the other'}")
        _report(w.name, gpu)
        print(f"{w.name} host ms per measured batch inside the stages: " + ", ".join(
            f"{k2} {v:.3f}" for k2, v in gpu["screen_ms"].items()) + f"; forced path: "
            f"{forced['pods_per_s']:.1f} pods/s, median {forced['median_ms']:.2f} ms per batch; "
            f"cpu {cpu['median_ms']:.2f} ms per batch")
        out[w.name] = row
    on_card, on_cpu = _reject_case("cuda"), _reject_case("cpu")
    if on_card != on_cpu:
        raise AssertionError("reject case: the card's run differs from the cpu's")
    print(f"reject case: a gang of 8 anti-affine members on 6 hosts and a slice gang of 65 "
          f"hosts rejected whole (infeasible) on cuda and cpu alike, the plain pods placed; "
          f"PodGroups {on_card['status']}; rejections {on_card['rejections']}; modes "
          f"{on_card['modes']}; requested after the next sync == a fresh encode")
    return out


# ---------------------------------------------------------------- quota phase


class _QuotaWatch:
    """Stands in for ``batch.quota_screen`` during a run: counts its calls
    and keeps (on the device, copied after the run) the inputs and result
    of the call with the most screened rows."""

    def __init__(self):
        self.inner = batch.quota_screen
        self.calls = 0
        self.captured = None

    def __call__(self, node_idx, ns_idx, req, used, limit):
        out = self.inner(node_idx, ns_idx, req, used, limit)
        rows = int((np.asarray(ns_idx) >= 0).sum())
        if self.captured is None or rows > self.captured["rows"]:
            self.captured = {"rows": rows, "ns": np.array(ns_idx),
                             "args": [node_idx, req, used, limit], "result": out}
        self.calls += 1
        return out


def _timed_batches(sched) -> list:
    """Wraps ``sched._schedule_batch``: each batch's host ms, pods, stage
    and screen ms, and the pods the quota gate turned away and the
    winners the screen flagged, per namespace. Returns the records (of
    the calls that ran a batch: a call whose pods all fail the gates runs
    none)."""
    records = []
    inner = sched._schedule_batch

    def timed(pods):
        s0, c0 = dict(sched.stage_seconds), dict(sched.screen_seconds)
        g0, f0 = dict(sched.quota_gated), dict(sched.quota_flagged)
        b0 = sched.batches
        t0 = time.perf_counter()
        out = inner(pods)
        if sched.batches == b0:
            return out  # every pod failed a PreFilter: no batch ran
        records.append({
            "ms": (time.perf_counter() - t0) * 1e3, "pods": len(pods),
            "failed": sum(v is None for v in out.values()),
            "gated": {k: v - g0.get(k, 0) for k, v in sched.quota_gated.items()
                      if v != g0.get(k, 0)},
            "flagged": {k: v - f0.get(k, 0) for k, v in sched.quota_flagged.items()
                        if v != f0.get(k, 0)},
            "namespaces": {p.meta.namespace for p in pods},
            "path": sched.batch_paths[-1],
            "stages": {k: (v - s0[k]) * 1e3 for k, v in sched.stage_seconds.items()},
            "screens": {k: (v - c0[k]) * 1e3 for k, v in sched.screen_seconds.items()}})
        return out

    sched._schedule_batch = timed
    return records


def _run_soak(w, device) -> dict:
    watch, qwatch = _Watch(), _QuotaWatch()
    batch_scheduler.schedule_batch, batch.quota_screen = watch, qwatch
    try:
        sched = BatchScheduler(w.node_infos(), caps=w.caps(), device=device, client=w.store())
        records = _timed_batches(sched)
        t0 = time.perf_counter()
        out = workloads.run_soak(sched, w)
        wall_s = time.perf_counter() - t0
    finally:
        batch_scheduler.schedule_batch, batch.quota_screen = watch.inner, qwatch.inner
    return {**out, "sched": sched, "watch": watch, "qwatch": qwatch, "records": records,
            "wall_s": wall_s, "quota_rejected": dict(sched.quota_rejected),
            "nominated": dict(sched.nominated), "gang_rejected": dict(sched.gang_rejected),
            "flagged": dict(sched.quota_flagged), "gated": dict(sched.quota_gated),
            "modes": sched.batch_modes, "paths": sched.batch_paths}


SOAK_KEYS = ("placed", "bound", "passes", "rounds", "pending", "quota_rejected", "nominated",
             "gang_rejected", "flagged", "gated", "modes")


def _quota_screen_on_card(name: str, cap: dict) -> dict:
    """The captured batch's screen: the card's result against the CPU's on
    the same inputs, one call under set_sync_debug_mode("error"), CUDA-event
    ms and the profile."""
    args = [a.cpu() for a in cap["args"]]
    want = batch.quota_screen(args[0], cap["ns"], *args[1:])
    if not torch.equal(cap["result"].cpu(), want):
        raise AssertionError(f"{name}: the quota screen differs between cuda and cpu")
    dev = [a.to("cuda") for a in args]
    call = (dev[0], cap["ns"], *dev[1:])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = batch.quota_screen(*call)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"{name}: the quota screen on the card differs from its capture")
    times, _ = _event_ms(lambda: batch.quota_screen(*call))
    prof = _profiled(batch.quota_screen, call, {})
    return {"ms": statistics.median(times), "min": min(times), "max": max(times),
            "kernels": prof["kernels"], "device_ms": prof["device_ms"],
            "wall_ms": prof["wall_ms"], "launch_calls": prof["launch_calls"],
            "rows": cap["rows"], "shape": f"[P={args[0].shape[0]}, NS={args[2].shape[0]}, "
                                          f"Q={args[2].shape[1]}], {cap['rows']} screened rows"}


def quota_phase() -> dict:
    """SchedulingSoak, SchedulingSoak/Cohort and SchedulingSoak/NoGangs
    through ``run_soak`` on the card (auto), on the CPU and on the card with
    the rounds forced. The first two are in mode ``host`` (the rounds) in
    every batch; /NoGangs is in mode ``off``: the fused kernel, then the
    screen, in every batch."""
    out = {}
    for w in (workloads.scheduling_soak(), workloads.scheduling_soak(cohort="soak"),
              workloads.scheduling_soak(gangs=False)):
        fused_step.LAUNCHES = 0
        gpu = _run_soak(w, "cuda")
        launches = fused_step.LAUNCHES
        cpu = _run_soak(w, "cpu")
        with _spec_flag("1"):
            spec = _run_soak(w, "cuda")
        for run, what in ((gpu, "cuda"), (cpu, "cpu"), (spec, "spec")):
            if run["oversubscription"]:
                raise AssertionError(f"{w.name} ({what}): {run['oversubscription']} "
                                     "oversubscribed quota dimensions")
            if run["sched"].fallback:
                raise AssertionError(f"{w.name} ({what}): fallback {run['sched'].fallback}")
        for key in SOAK_KEYS:
            if gpu[key] != cpu[key] or spec[key] != gpu[key]:
                raise AssertionError(f"{w.name}: {key} differ across cuda, cpu and spec")
        off = sum(m == "off" for m in gpu["modes"])
        fused = [p for m, p in zip(gpu["modes"], gpu["paths"]) if m == "off"]
        if launches != off or set(fused) - {"fused"} or gpu["watch"].fused_launches["off"] != off:
            raise AssertionError(f"{w.name}: {launches} kernel launches for {off} mode-off "
                                 "batches")
        bad = [(c, r, n) for c, r, n in spec["watch"].spec if r != n]
        if bad:
            raise AssertionError(f"{w.name}: host reads differ from rounds in {bad[:3]}")
        if "NoGangs" in w.name and (off != len(gpu["modes"]) or off == 0):
            raise AssertionError(f"{w.name}: batches in modes {gpu['modes']}, not all off")
        # a winner flagged in a batch whose tenant the gate let through whole
        clean = [(i, ns, r["path"]) for i, r in enumerate(gpu["records"]) for ns in r["flagged"]
                 if ns not in r["gated"]]
        if not clean:
            raise AssertionError(f"{w.name}: no winner flagged in a batch the gate let through")
        if "NoGangs" in w.name and not any(path == "fused" for _i, _ns, path in clean):
            raise AssertionError(f"{w.name}: no winner flagged after the fused kernel")
        screen = _quota_screen_on_card(w.name, gpu["qwatch"].captured)
        recs = gpu["records"]
        stages = {k: statistics.median(r["stages"][k] for r in recs) for k in recs[0]["stages"]}
        screens = {k: statistics.median(r["screens"][k] for r in recs)
                   for k in ("quota_gate", "quota_table", "quota_reserve", "preempt_host")}
        print(f"{w.name}: {sum(gpu['bound'].values())} pods bound over {w.rounds} rounds "
              f"(per tenant {gpu['bound']}), {len(gpu['pending'])} pending at the end, "
              f"{gpu['passes']} passes in {len(recs)} batches (modes "
              f"{dict((m, gpu['modes'].count(m)) for m in sorted(set(gpu['modes'])))}, paths "
              f"{sorted(set(gpu['paths']))}); gate turned away {gpu['gated']}, screen flagged "
              f"{gpu['flagged']} (first clean batch {clean[0]}); 0 oversubscription at every "
              f"pass; placements, rejections, nominations and ledgers == cpu run == the rounds "
              f"forced; {launches} kernel launches for {off} mode-off batches")
        print(f"{w.name} on cuda: median {statistics.median(r['ms'] for r in recs):.2f} ms per "
              f"batch (min {min(r['ms'] for r in recs):.2f}, max "
              f"{max(r['ms'] for r in recs):.2f}); median host ms by stage: "
              + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
              + "; of which " + ", ".join(f"{k} {v:.2f}" for k, v in screens.items())
              + f"; whole run {gpu['wall_s']:.2f} s, cpu {cpu['wall_s']:.2f} s, rounds forced "
              f"{spec['wall_s']:.2f} s; {gpu['qwatch'].calls} screened batches")
        print(f"{w.name} quota_screen on the batch {screen['shape']}: cuda == cpu exactly, no "
              f"host read under set_sync_debug_mode(\"error\"); median {screen['ms']:.4f} ms "
              f"over {TIMED_LAUNCHES} (CUDA events; min {screen['min']:.4f}, max "
              f"{screen['max']:.4f}); {screen['kernels']} CUDA kernels, "
              f"{screen['launch_calls']} kernel-launch calls, device busy "
              f"{screen['device_ms']:.4f} ms of {screen['wall_ms']:.2f} ms wall")
        out[w.name] = {"launches": launches, "screen": screen,
                       "median_ms": statistics.median(r["ms"] for r in recs)}
    return out


# ---------------------------------------------------------------- preempt_all phase


class _ModeScreenWatch(_ScreenWatch):
    """``_ScreenWatch`` keeping one capture per topology mode (the mode of
    the batch ``watch`` saw last)."""

    def __init__(self, watch: "_Watch"):
        super().__init__()
        self.watch = watch
        self.by_mode = {}

    def __call__(self, pb, nt, static_masks, failed_prefix):
        self.captured = self.by_mode.get(self.watch.last_mode)
        out = super().__call__(pb, nt, static_masks, failed_prefix)
        self.by_mode[self.watch.last_mode] = self.captured
        return out


def _run_preempt_all(w, device) -> dict:
    watch = _Watch()
    screens = _ModeScreenWatch(watch)
    batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = watch, screens
    try:
        sched = BatchScheduler(w.node_infos(), caps=w.caps(), device=device, client=w.store())
        records = _timed_batches(sched)
        t0 = time.perf_counter()
        placed, rounds = workloads.run_with_preemption(sched, w)
        wall_s = time.perf_counter() - t0
    finally:
        batch_scheduler.schedule_batch, batch_scheduler.screen_prefix = (watch.inner,
                                                                          screens.inner)
    return {"placed": placed, "rounds": rounds, "preempted": dict(sched.preempted),
            "sched": sched, "watch": watch, "screens": screens, "records": records,
            "wall_s": wall_s, "modes": sched.batch_modes, "paths": sched.batch_paths}



def _check_preempt_all(name: str, w, run: dict, what: str) -> None:
    sched, placed = run["sched"], run["placed"]
    preemptors = [p.key() for p in w.measured_pod_list()]
    unbound = [k for k in preemptors if placed.get(k) is None]
    if unbound or sched.nominated or sched.fallback or sched.retry:
        raise AssertionError(f"{name} ({what}): {len(unbound)} of {len(preemptors)} preemptors "
                             f"unbound after {len(run['rounds'])} rounds, "
                             f"{len(sched.nominated)} nominated, fallback {sched.fallback}, "
                             f"retry {sched.retry}")
    for ni in sched.snapshot.node_info_map.values():
        if (ni.requested.milli_cpu > ni.allocatable.milli_cpu
                or ni.requested.memory > ni.allocatable.memory
                or len(ni.pods) > ni.allocatable.allowed_pod_number):
            raise AssertionError(f"{name} ({what}): {ni.node.meta.name} over its allocatable")
    init = -(-w.init_pods // P)
    if run["modes"][init:init + 3] != ["off", "host", "general"]:
        raise AssertionError(f"{name} ({what}): preemptor batches in modes "
                             f"{run['modes'][init:init + 3]}")


def preempt_all_phase() -> dict:
    """PreemptionAll on the card (auto), on the CPU and on the card with the
    rounds forced."""
    w = workloads.preemption_all()
    fused_step.LAUNCHES = 0
    gpu = _run_preempt_all(w, "cuda")
    launches = fused_step.LAUNCHES
    cpu = _run_preempt_all(w, "cpu")
    with _spec_flag("1"):
        spec = _run_preempt_all(w, "cuda")
    for run, what in ((gpu, "cuda"), (cpu, "cpu"), (spec, "spec")):
        _check_preempt_all(w.name, w, run, what)
    for key in ("placed", "rounds", "preempted", "modes"):
        if gpu[key] != cpu[key] or spec[key] != gpu[key]:
            raise AssertionError(f"{w.name}: {key} differ across cuda, cpu and spec")
    off = sum(m == "off" for m in gpu["modes"])
    if launches != off:
        raise AssertionError(f"{w.name}: {launches} kernel launches for {off} mode-off batches")
    init = -(-w.init_pods // P)
    by_mode = {}
    for mode, cap in sorted(gpu["screens"].by_mode.items()):
        by_mode[mode] = _screen_on_card(f"{w.name} ({mode})", cap)
    recs = gpu["records"][init:]
    print(f"{w.name}: all {len(w.measured_pod_list())} preemptors (claim, anti-affine, spread; "
          f"first batches in modes off, host, general) bound in {len(gpu['rounds'])} "
          f"resubmission rounds (nominated before each: {[len(r) for r in gpu['rounds']]}), "
          f"{len(gpu['preempted'])} victims, fallback empty; placements, nominations and "
          f"victims == cpu run == the rounds forced; {launches} kernel launches for {off} "
          f"mode-off batches; every node within its allocatable; whole run "
          f"{gpu['wall_s']:.2f} s, cpu {cpu['wall_s']:.2f} s, rounds forced {spec['wall_s']:.2f} s")
    for i, (rec, mode) in enumerate(zip(recs[:3], ("off", "host", "general"))):
        print(f"{w.name} first {mode} batch on cuda: {rec['ms']:.2f} ms, {rec['failed']} failed "
              f"pods, screen with its read {rec['screens']['preempt_screen']:.2f} ms, host "
              f"Evaluator {rec['screens']['preempt_host']:.2f} ms; host ms by stage: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["stages"].items()))
    for mode, screen in by_mode.items():
        print(f"{w.name} preempt_screen, mode {mode}, on the failing batch {screen['shape']}: "
              f"cuda == cpu exactly, no host read under set_sync_debug_mode(\"error\"); median "
              f"{screen['ms']:.4f} ms (CUDA events; min {screen['min']:.4f}, max "
              f"{screen['max']:.4f}); {screen['kernels']} CUDA kernels, device busy "
              f"{screen['device_ms']:.4f} ms of {screen['wall_ms']:.2f} ms wall")
    return {w.name: {"launches": launches, "screens": by_mode}}


# ---------------------------------------------------------------- loop phase


def _loop_report(name: str, run: dict) -> None:
    ms = run["measured_batch_ms"] or [0.0]  # [0.0]: no measured cycle ran a batch
    n = len(run["measured_batch_ms"])
    m = max(run["measured_batches"], 1)
    ring = (f"ring depth {run['pipeline_depth']}, commit worker "
            f"{'on' if run['commit_worker'] else 'off'}")
    print(f"{name} through the loop ({ring}): {run['metrics']['scheduled']} pods bound in "
          f"{run['batches']} batches (paths {sorted(set(run['paths']))}), fused-kernel "
          f"launches {run['launches']}; measured phase {run['pods_per_s']:.1f} pods/s over "
          f"{run['measured_s']:.3f} s, {n} cycles of median {statistics.median(ms):.2f} ms "
          f"(min {min(ms):.2f}, max {max(ms):.2f}) on the scheduling thread, the settle "
          f"loop's no-progress sleeps {run['measured_idle_ms']:.2f} ms; attempt ms (pop "
          "to commit) " + ", ".join(f"{k} {v:.2f}" for k, v in run["attempt_ms"].items())
          + f"; {run['measured_carry_batches']} of {run['measured_batches']} measured batches "
          f"encoded on the carry; host ms per measured batch on the scheduling thread: "
          + ", ".join(f"{k} {v / m:.2f}" for k, v in run["measured_stage_ms"].items())
          + "; commit ms per measured batch: "
          + ", ".join(f"{k} {v / m:.2f}" for k, v in run["measured_commit_ms"].items())
          + "; per batch over the whole run: "
          + ", ".join(f"{k} {v / run['batches']:.2f}" for k, v in run["stage_ms"].items())
          + f"; measured phase: encode+dispatch spans {run['measured_dispatch_ms']:.2f} ms, "
          f"host commit spans {run['measured_commit_host_ms']:.2f} ms, both at once "
          f"{run['measured_overlap_ms']:.2f} ms")


def _check_loop_same(name: str, got: dict, want: dict, keys) -> None:
    for key in keys:
        if got[key] != want[key]:
            raise AssertionError(f"{name} through the loop: {key} differs from the cpu run")


@contextlib.contextmanager
def _env(**values):
    """Set (a string) or clear (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# loop_basic_phase's keys for the CPU loop's SchedulingBasic and PreemptionBasic runs
CPU_BASIC = "cpu"
CPU_PREEMPT = "cpu_preempt"
# the ring at its default (depth 2, commits inline), synchronous, and the
# ring with the commit worker
RING = dict(KTPU_PIPELINE_DEPTH=None, KTPU_COMMIT_WORKER=None)
SYNC = dict(RING, KTPU_PIPELINE_DEPTH="0")
WORKER = dict(RING, KTPU_COMMIT_WORKER="1")


def _no_silent_degrade(label: str, run: dict) -> None:
    """Outside the scripted flap no commit may fail: a kernel that failed
    quietly into the sequential path would open the relay breaker."""
    if run["relay_opens"] or run["relay_degraded_pods"]:
        raise AssertionError(f"{label}: the relay breaker opened {run['relay_opens']} times, "
                             f"{run['relay_degraded_pods']} pods degraded")


def _loop_run(w, label: str, env: dict, **kw) -> dict:
    with _env(**env):
        fused_step.LAUNCHES = 0
        run = workloads.run_loop(w, "cuda", **kw)
    if run["launches"] + run["warm_launches"] != fused_step.LAUNCHES:
        raise AssertionError(f"{label}: launches counted twice")
    _no_silent_degrade(label, run)
    _loop_report(label, run)
    return run


def _check_all_bound(name: str, w, run: dict) -> None:
    if run["settle_abandoned"] or not all(run["placed"].values()) \
            or len(run["placed"]) != w.n_init + w.n_measured:
        raise AssertionError(f"{name} through the loop: not every pod bound")


class _StrictDispatch:
    """Runs the ``at``-th ring dispatch under ``set_sync_debug_mode("error")``."""

    def __init__(self, inner, at: int):
        self.inner, self.at, self.calls, self.checked = inner, at, 0, None

    def __call__(self, state, enc, *args):
        self.calls += 1
        if self.calls != self.at:
            return self.inner(state, enc, *args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = self.inner(state, enc, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.checked = out.path
        return out


def loop_basic_phase() -> dict:
    """The scheduler loop on the card at SchedulingBasic/5000Nodes: the
    in-flight ring against the synchronous loop and the commit worker; and
    PreemptionBasic (inline ring exact, worker ring bound). Returns the CPU
    loop's SchedulingBasic and PreemptionBasic runs under ``CPU_BASIC`` and
    ``CPU_PREEMPT`` beside the card's runs: the later loop phases of its
    group hold their runs against them."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    with _env(**RING):
        cpu = workloads.run_loop(basic, "cpu", percentage=100)
    turns = {"ring": [], "sync": [], "worker": []}
    envs = {"ring": RING, "sync": SYNC, "worker": WORKER}
    # one turn each: the later phases need the time (the loop_telemetry
    # phase runs the ring again, off / on in turns)
    for i, kind in enumerate(("ring", "sync", "worker")):
        gpu = _loop_run(basic, f"{basic.name} [{kind} {i // 3 + 1}]", envs[kind])
        _check_all_bound(basic.name, basic, gpu)
        if set(gpu["paths"]) != {"fused"} or gpu["launches"] != gpu["batches"]:
            raise AssertionError(f"{basic.name} [{kind}]: paths {set(gpu['paths'])}, "
                                 f"{gpu['launches']} launches for {gpu['batches']} batches")
        _check_loop_same(f"{basic.name} [{kind}]", gpu, cpu, ("placed", "cycles", "paths"))
        if kind != "sync" and not (gpu["commit_worker"] == (kind == "worker")
                                   and gpu["measured_carry_batches"]):
            raise AssertionError(f"{basic.name} [{kind}]: worker or carry not as set")
        turns[kind].append(gpu)
    for kind, runs in turns.items():
        print(f"{basic.name} {kind} in turns: pods/s "
              + " / ".join(f"{r['pods_per_s']:.1f}" for r in runs) + "; attempt p50 "
              + " / ".join(f"{r['attempt_ms']['p50']:.2f}" for r in runs) + ", p99 "
              + " / ".join(f"{r['attempt_ms']['p99']:.2f}" for r in runs) + " ms; idle sleeps "
              + " / ".join(f"{r['measured_idle_ms']:.2f}" for r in runs) + " ms; carry share "
              + " / ".join(f"{r['measured_carry_batches']}/{r['measured_batches']}"
                           for r in runs) + "; host commit beside encode+dispatch "
              + " / ".join(f"{r['measured_overlap_ms']:.2f} of {r['measured_commit_host_ms']:.2f}"
                           for r in runs) + " ms")
    print(f"{basic.name}: every run's placements == the cpu loop at percentage 100 (inline "
          f"ring), one kernel launch per batch")
    out[f"{basic.name}/ring"] = {"launches": turns["ring"][0]["launches"], "run": turns["ring"]}
    out[f"{basic.name}/sync"] = {"launches": turns["sync"][0]["launches"], "run": turns["sync"]}
    out[f"{basic.name}/worker"] = {"launches": turns["worker"][0]["launches"],
                                   "run": turns["worker"]}
    part("basic turns")

    pre = workloads.preemption_basic()
    with _env(**RING):
        p_cpu = workloads.run_loop(pre, "cpu", percentage=100)
    for label, env in (("inline ring", RING), ("worker ring", WORKER)):
        p_gpu = _loop_run(pre, f"{pre.name} [{label}]", env)
        preemptors = [k for k in p_gpu["placed"] if "/preemptor-" in k or "/warm-" in k]
        if not all(p_gpu["placed"][k] for k in preemptors) or p_gpu["settle_abandoned"]:
            raise AssertionError(f"{pre.name} [{label}]: a preemptor is unbound")
        if p_gpu["launches"] != p_gpu["batches"]:
            raise AssertionError(f"{pre.name} [{label}]: {p_gpu['launches']} launches for "
                                 f"{p_gpu['batches']} batches")
        if label == "inline ring":
            _check_loop_same(pre.name, p_gpu, p_cpu,
                             ("placed", "preempted", "nominations", "cycles", "metrics"))
        print(f"{pre.name} through the {label}: {len(preemptors)} preemptors bound, "
              f"{len(p_gpu['preempted'])} victims, {len(p_gpu['nominations'])} nominations, "
              f"pods popped per settle {p_gpu['cycles']}"
              + ("; all == cpu" if label == "inline ring" else
                 f" (the cpu's inline ring: {len(p_cpu['preempted'])} victims, "
                 f"{len(p_cpu['nominations'])} nominations, {p_cpu['cycles']})"))
        out[f"{pre.name}/{label.split()[0]}"] = {"launches": p_gpu["launches"], "run": p_gpu}
    part("preemption")
    print("loop_basic phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    out[CPU_BASIC] = cpu
    out[CPU_PREEMPT] = p_cpu
    return out


def loop_phase(topo: dict, spec: dict) -> dict:
    """The scheduler loop on the card beside BatchScheduler's runs: one
    ring dispatch on the carry under the strict sync mode, the topology
    workloads through the ring (capacity growth) and the sampled loop. The
    ring at the default deadline runs in the loop_faults phase, cold
    against warmed."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    # one ring dispatch on the carry (the third, inline: the mode is
    # process-wide) under the strict mode
    strict = _StrictDispatch(tpu_scheduler.dispatch_device_batch, at=3)
    tpu_scheduler.dispatch_device_batch = strict
    try:
        small = workloads.scheduling_basic(N_NODES, 0, 4 * P)
        run = _loop_run(small, f"{small.name}/512 pods [ring, strict dispatch 3]", RING)
    finally:
        tpu_scheduler.dispatch_device_batch = strict.inner
    if strict.checked != "fused" or run["carry_batches"] < 1:
        raise AssertionError(f"strict dispatch: {strict.checked}, carry {run['carry_batches']}")
    print("one ring dispatch on the carry (fused kernel, carry adopted, packed block staged "
          "to pinned memory) ran under set_sync_debug_mode('error'): no host read")
    part("strict")

    for name, prev in topo.items():
        w = prev["workload"]
        gpu = _loop_run(w, f"{w.name} [ring]", RING)
        with _env(**RING):
            t_cpu = time.perf_counter()
            cpu_run = workloads.run_loop(w, "cpu", percentage=100)
            cpu_s = time.perf_counter() - t_cpu
        _check_all_bound(w.name, w, gpu)
        _check_loop_same(w.name, gpu, cpu_run, ("placed", "cycles", "modes"))
        caps = {k: v for k, v in gpu["caps"].items() if v != cpu_run["caps"][k]}
        if caps:
            raise AssertionError(f"{w.name}: grown capacities differ from the cpu's: {caps}")
        bs = spec[name]["pods_per_s"]
        print(f"{w.name} through the ring: placements == the cpu loop ({cpu_s:.1f} s), "
              f"capacities grown past caps_for_cluster: {gpu['grown'] or 'none'}; "
              f"paths {sorted(set(gpu['paths']))}; "
              f"{gpu['pods_per_s']:.1f} pods/s, attempt p99 {gpu['attempt_ms']['p99']:.2f} ms; "
              f"BatchScheduler in this call: rounds {bs['spec']:.1f} pods/s, "
              f"{bs_other(prev)} {bs['other']:.1f} pods/s")
        out[f"{w.name}/ring"] = {"launches": gpu["launches"], "run": gpu}
    part("topology")

    sampled = workloads.scheduling_basic(1000, 0, 256)
    s_gpu = _loop_run(sampled, f"{sampled.name} at percentage 10 [ring]", RING, percentage=10)
    with _env(**RING):
        s_cpu = workloads.run_loop(sampled, "cpu", percentage=10)
    if (set(s_gpu["paths"]) != {"scan"} or s_gpu["launches"] != 0 or s_gpu["settle_abandoned"]
            or len(s_gpu["placed"]) != sampled.n_measured or not all(s_gpu["placed"].values())):
        raise AssertionError(f"sampled loop: paths {set(s_gpu['paths'])}, {s_gpu['launches']} "
                             "kernel launches, or a pod unbound")
    _check_loop_same("sampled loop", s_gpu, s_cpu, ("placed", "start", "cycles"))
    print(f"sampled loop: {s_gpu['batches']} batches on the scan, final window start "
          f"{s_gpu['start']} == cpu, placements == cpu")
    out["sampled"] = {"launches": s_gpu["launches"], "run": s_gpu}
    part("sampled")
    print("loop phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return out


# ---------------------------------------------------------------- loop_gang phase


def _group_sizes(w) -> dict:
    """Pod key -> (group key, gang size) of a workload's gang pods."""
    return {p.key(): (workloads.pod_group_key(p), shape.gang_size)
            for shape, count in w._ops() if shape.gang_size for p in shape.pods(count)}


def _check_atomic(name: str, w, run: dict) -> None:
    """Every gang bound whole, Running, and nothing left waiting."""
    bound = {}
    for key, (gkey, size) in _group_sizes(w).items():
        bound.setdefault(gkey, [0, size])[0] += bool(run["placed"].get(key))
    partial = {g: b for g, b in bound.items() if b[0] not in (0, b[1])}
    if partial or run["waiting"] or run["settle_abandoned"]:
        raise AssertionError(f"{name} through the loop: partial gangs {partial}, waiting "
                             f"{run['waiting']}")
    if any(ph != "Running" or n != bound[g][1] for g, (ph, n) in run["pod_groups"].items()):
        raise AssertionError(f"{name} through the loop: PodGroups {run['pod_groups']}")


LOOP_GANG_KEYS = ("placed", "gang_rejected", "pod_groups", "batch_pods", "cycles", "modes")
SOAK_LOOP_KEYS = ("placed", "bound", "rounds", "batch_pods", "pending", "evicted", "reclaims",
                  "flagged", "gang_rejected", "pod_groups", "modes", "oversubscription",
                  "checks", "flap_batches", "relay_degraded_pods", "breaker", "degraded_s",
                  "fallback_scheduled")


def _flap_note(run: dict) -> str:
    return (f"; the flap: {run['flap_batches']} commits failed, the breaker open "
            f"{run['breaker'].count(2)} cycles, {run['degraded_s']:.2f} degraded s on the "
            f"soak's clock, {run['relay_degraded_pods']} pods degraded to the sequential path")


def _check_flap(name: str, run: dict) -> None:
    """The soak's scripted flap: three commits failed, the breaker opened
    once and was closed at the end."""
    if (run["flap_batches"] != workloads.SOAK_FLAP_BATCHES or run["relay_opens"] != 1
            or run["breaker_state"] != 0 or not run["degraded_s"]):
        raise AssertionError(f"{name}: flap batches {run['flap_batches']}, breaker opened "
                             f"{run['relay_opens']} times, state {run['breaker_state']} at "
                             f"the end, {run['degraded_s']} degraded s")


def loop_gang_phase(gangs: dict, quota: dict) -> dict:
    """SchedulingGangs and SchedulingSlices through ``run_loop`` (the
    inline ring), and SchedulingSoak/Cohort and /NoGangs (with their claim
    pods; the plain soak runs in the loop_claims phase) through
    ``run_loop_soak``, on the card and on the CPU in this call."""
    out = {}
    for w in (workloads.scheduling_gangs(), workloads.scheduling_slices()):
        slices = bool(w.tpu_slots)
        gpu = _loop_run(w, f"{w.name} [ring]", RING)
        with _env(**RING):
            cpu = workloads.run_loop(w, "cpu", percentage=100)
        _check_all_bound(w.name, w, gpu)
        _check_atomic(w.name, w, gpu)
        _check_loop_same(w.name, gpu, cpu, LOOP_GANG_KEYS)
        if slices and (set(gpu["modes"]) != {"off"} or gpu["launches"] != gpu["batches"]
                       or gpu["slice_stats"]["ContiguityViolations"]):
            raise AssertionError(f"{w.name} through the loop: modes {set(gpu['modes'])}, "
                                 f"{gpu['launches']} launches for {gpu['batches']} batches, "
                                 f"slice stats {gpu['slice_stats']}")
        ms = gpu["measured_batch_ms"]
        print(f"{w.name} through the loop: every gang bound whole and Running, none waiting "
              f"at Permit; placements, rejections, PodGroups, pods popped per batch "
              f"{gpu['batch_pods']} and modes == the cpu loop; {gpu['pods_per_s']:.1f} pods/s, "
              f"attempt p50 {gpu['attempt_ms']['p50']:.2f} ms, p99 "
              f"{gpu['attempt_ms']['p99']:.2f} ms; median {statistics.median(ms):.2f} ms per "
              f"measured batch; gang_verdicts {gpu['gang_ms']:.2f} ms over {gpu['gang_reads']} "
              f"reads; {gpu['launches']} fused launches for {gpu['batches']} batches; "
              f"capacities grown past caps_for_cluster: {gpu['grown'] or 'none'}"
              + (f"; slice stats {gpu['slice_stats']}" if slices else "")
              + f"; BatchScheduler in this call (gang phase) "
              f"{gangs[w.name]['gpu']['median_ms']:.2f} ms per batch")
        out[w.name] = {"launches": gpu["launches"], "run": gpu}
    for w in (workloads.scheduling_soak(cohort="soak"), workloads.scheduling_soak(gangs=False)):
        with _env(**RING):
            fused_step.LAUNCHES = 0
            gpu = workloads.run_loop_soak(w, "cuda")
            if gpu["launches"] != fused_step.LAUNCHES:
                raise AssertionError(f"{w.name}: launches counted twice")
            cpu = workloads.run_loop_soak(w, "cpu", percentage=100)
        _check_loop_same(w.name, gpu, cpu, SOAK_LOOP_KEYS)
        _check_flap(w.name, gpu)
        if gpu["oversubscription"] or gpu["waiting"]:
            raise AssertionError(f"{w.name} through the loop: {gpu['oversubscription']} "
                                 f"oversubscribed dimensions, waiting {gpu['waiting']}")
        off = sum(m == "off" for m in gpu["modes"])
        if gpu["launches"] != off:
            raise AssertionError(f"{w.name} through the loop: {gpu['launches']} launches for "
                                 f"{off} mode-off batches")
        if "NoGangs" in w.name and (off != len(gpu["modes"]) or not gpu["flagged"]):
            raise AssertionError(f"{w.name} through the loop: modes {set(gpu['modes'])}, "
                                 f"{gpu['flagged']} winners flagged")
        busy = gpu["batch_ms"] or [0.0]
        print(f"{w.name} through the loop: {sum(gpu['bound'].values())} pods bound over "
              f"{w.rounds} rounds (per tenant {gpu['bound']}) in {len(gpu['batch_pods'])} "
              f"batches over {gpu['cycles']} cycles; 0 oversubscription at {gpu['checks']} "
              f"checks; pending at the end {gpu['pending']}; {gpu['flagged']} winners flagged "
              f"by the device screen, {gpu['evicted']} pods evicted by {gpu['reclaims']} "
              f"reclaim passes; gangs rejected {gpu['gang_rejected']}; all == the cpu loop; "
              f"{gpu['pods_per_s']:.1f} pods/s over {gpu['soak_s']:.2f} s (cpu "
              f"{cpu['soak_s']:.2f} s); attempt p50 {gpu['attempt_ms']['p50']:.2f} ms, p99 "
              f"{gpu['attempt_ms']['p99']:.2f} ms on the soak's clock (50 ms per cycle); "
              f"median {statistics.median(busy):.2f} ms per cycle that ran a batch "
              f"(max {max(busy):.2f}); host ms per batch by stage: "
              + ", ".join(f"{k} {v / max(len(busy), 1):.2f}" for k, v in gpu["stage_ms"].items())
              + "; commit ms per batch: "
              + ", ".join(f"{k} {v / max(len(busy), 1):.2f}" for k, v in gpu["commit_ms"].items())
              + f"; gang_verdicts {gpu['gang_ms']:.2f} ms over {gpu['gang_reads']} reads; "
              f"{gpu['launches']} fused launches for {off} mode-off batches; BatchScheduler's "
              f"soak in this call {quota[w.name]['median_ms']:.2f} ms per batch"
              + _flap_note(gpu))
        out[w.name] = {"launches": gpu["launches"], "run": gpu}
    return out


# the loop's claim and volume runs: what the card's run must share with the
# CPU's, and the pods the SchedulingInTreePVs and SchedulingCSIPVs runs
# create before the measured 1000 (5000 published; a depth cut, PERF.md 4)
LOOP_CLAIM_KEYS = ("placed", "batch_pods", "cycles", "modes", "paths", "metrics",
                   "fallback_scheduled", "pv_bindings", "claims")
LOOP_PV_INIT = 1000


def _check_claim_loop(name: str, gpu: dict, cpu: dict, keys) -> int:
    """Card == CPU on ``keys``; one fused launch per full mode-off batch;
    no CSINode limit exceeded, no ReadWriteOncePod claim shared, every
    bound claim pod's claim allocated to its node. Returns the mode-off
    batches."""
    _check_loop_same(name, gpu, cpu, keys)
    off = sum(m == "off" for m in gpu["modes"])
    fused = sum(m == "off" and p == "fused" for m, p in zip(gpu["modes"], gpu["paths"]))
    if gpu["launches"] != off or fused != off:
        raise AssertionError(f"{name} through the loop: {gpu['launches']} fused launches, "
                             f"{fused} fused batches for {off} mode-off batches")
    if gpu["csi_over"] or gpu["rwop_shared"]:
        raise AssertionError(f"{name} through the loop: CSINode limits exceeded on "
                             f"{gpu['csi_over']}, ReadWriteOncePod claims shared "
                             f"{gpu['rwop_shared']}")
    for claim_key, (node, users) in gpu["claims"].items():
        for pod_key in users:
            if gpu["placed"].get(pod_key, node) != node:
                raise AssertionError(f"{name}: claim {claim_key} on {node}, its pod {pod_key} "
                                     f"on {gpu['placed'][pod_key]}")
    return off


def loop_claims_phase(dra: dict) -> dict:
    """Claims and volumes through the loop (the inline ring), each on the
    card and on the CPU in this call: SchedulingDRA, SchedulingInTreePVs
    and SchedulingCSIPVs at 5000 nodes through ``run_loop``, SchedulingSoak
    /1000Nodes with its claim pods through ``run_loop_soak``, and the
    seeded delayed-binding case through ``run_delayed_binding``."""
    out = {}
    for w in (workloads.scheduling_dra(),
              workloads.scheduling_intree_pvs(init_pods=LOOP_PV_INIT),
              workloads.scheduling_csi_pvs(init_pods=LOOP_PV_INIT)):
        gpu = _loop_run(w, f"{w.name} [ring]", RING)
        with _env(**RING):
            cpu = workloads.run_loop(w, "cpu", percentage=100)
        _check_all_bound(w.name, w, gpu)
        off = _check_claim_loop(w.name, gpu, cpu, LOOP_CLAIM_KEYS)
        m = max(gpu["measured_batches"], 1)
        bs = dra.get(w.name)
        print(f"{w.name} through the loop: every pod bound, placements, pods popped per "
              f"batch, counters, PV bindings and claim allocations == the cpu loop; "
              f"{gpu['launches']} fused launches for {off} mode-off batches; "
              f"{gpu['fallback_scheduled']} pods bound by the sequential path; "
              f"{len([c for c in gpu['claims'].values() if c[0]])} claims allocated, "
              f"{len([v for v in gpu['pv_bindings'].values() if v])} PVs bound; "
              f"{gpu['pods_per_s']:.1f} pods/s, attempt p50 {gpu['attempt_ms']['p50']:.2f} ms, "
              f"p99 {gpu['attempt_ms']['p99']:.2f} ms; median "
              f"{statistics.median(gpu['measured_batch_ms']):.2f} ms per measured batch; "
              "host ms per measured batch by stage: "
              + ", ".join(f"{k} {v / m:.2f}" for k, v in gpu["measured_stage_ms"].items())
              + "; commit ms per measured batch: "
              + ", ".join(f"{k} {v / m:.2f}" for k, v in gpu["measured_commit_ms"].items())
              + "; claim and volume ms per measured batch: "
              + ", ".join(f"{k} {v / m:.3f}" for k, v in gpu["measured_screen_ms"].items())
              + (f"; BatchScheduler in this call (dra phase) {bs['gpu']['median_ms']:.2f} ms "
                 "per batch" if bs else ""))
        out[w.name] = {"launches": gpu["launches"], "run": gpu}
    w = workloads.scheduling_soak()
    with _env(**RING):
        fused_step.LAUNCHES = 0
        gpu = workloads.run_loop_soak(w, "cuda")
        if gpu["launches"] != fused_step.LAUNCHES:
            raise AssertionError(f"{w.name}: launches counted twice")
        cpu = workloads.run_loop_soak(w, "cpu", percentage=100)
    _check_loop_same(w.name, gpu, cpu, SOAK_LOOP_KEYS + ("claims",))
    _check_flap(w.name, gpu)
    if gpu["oversubscription"] or gpu["waiting"] or not gpu["bound"]["soak-b"]:
        raise AssertionError(f"{w.name} through the loop: {gpu['oversubscription']} "
                             f"oversubscribed dimensions, waiting {gpu['waiting']}, claim "
                             f"tenant bound {gpu['bound']['soak-b']}")
    off = sum(mo == "off" for mo in gpu["modes"])
    if gpu["launches"] != off:
        raise AssertionError(f"{w.name} through the loop: {gpu['launches']} launches for "
                             f"{off} mode-off batches")
    busy = gpu["batch_ms"] or [0.0]
    print(f"{w.name} (with claims) through the loop: {sum(gpu['bound'].values())} pods bound "
          f"(per tenant {gpu['bound']}) in {len(gpu['batch_pods'])} batches over "
          f"{gpu['cycles']} cycles; {len([c for c in gpu['claims'].values() if c[0]])} claims "
          f"allocated; 0 oversubscription at {gpu['checks']} checks; "
          f"{gpu['fallback_scheduled']} pods bound by the sequential path; all == the cpu "
          f"loop; {gpu['pods_per_s']:.1f} pods/s over {gpu['soak_s']:.2f} s; attempt p50 "
          f"{gpu['attempt_ms']['p50']:.2f} ms, p99 {gpu['attempt_ms']['p99']:.2f} ms on the "
          f"soak's clock; median {statistics.median(busy):.2f} ms per cycle that ran a batch; "
          "claim and volume ms per batch: "
          + ", ".join(f"{k} {v / max(len(busy), 1):.3f}" for k, v in gpu["screen_ms"].items())
          + f"; {gpu['launches']} fused launches for {off} mode-off batches" + _flap_note(gpu))
    out[w.name] = {"launches": gpu["launches"], "run": gpu}
    c = workloads.DelayedBinding()
    with _env(**RING):
        fused_step.LAUNCHES = 0
        gpu = workloads.run_delayed_binding(c, "cuda")
        if gpu["launches"] != fused_step.LAUNCHES:
            raise AssertionError(f"{c.name}: launches counted twice")
        cpu = workloads.run_delayed_binding(c, "cpu")
    _no_silent_degrade(c.name, gpu)
    off = _check_claim_loop(c.name, gpu, cpu, ("placed", "batch_pods", "modes", "paths",
                                               "metrics", "fallback_scheduled", "pv_bindings",
                                               "rounds"))
    zones = {pv.meta.name: pv.node_affinity for pv in c.pv_list()}
    bound = {claim: pv for pv, claim in gpu["pv_bindings"].items() if claim}
    if len(bound) != c.pvs + c.extra_pvs or sum(map(bool, gpu["placed"].values())) != len(bound):
        raise AssertionError(f"{c.name}: {len(bound)} PVs bound, "
                             f"{sum(map(bool, gpu['placed'].values()))} pods bound")
    for claim, pv in bound.items():
        node = gpu["placed"][claim]
        zone = f"zone-{int(node.split('-')[1]) % 10}"
        if zone not in zones[pv]["topology.kubernetes.io/zone"]:
            raise AssertionError(f"{c.name}: {claim} on {node} ({zone}) bound to {pv}")
    print(f"{c.name} ({c.pods} pods, {c.pvs} + {c.extra_pvs} zonal PVs): every PV bound to "
          f"one pod on a node of its zone, the other pods parked; placements, PV bindings, "
          f"counters {gpu['metrics']} and pods popped == the cpu loop over {gpu['rounds']} "
          f"settles; {gpu['launches']} fused launches for {off} mode-off batches; "
          f"{gpu['pods_per_s']:.1f} pods bound per s; median "
          f"{statistics.median(gpu['batch_ms'] or [0.0]):.2f} ms per batch")
    out[c.name] = {"launches": gpu["launches"], "run": gpu}
    return out


# ---------------------------------------------------------------- loop_faults phase

# what the flap soak on the card must share with the CPU's
FLAP_KEYS = ("placed", "bound", "rounds", "batch_pods", "pending", "modes", "flap_batches",
             "relay_degraded_pods", "fallback_scheduled", "breaker", "degraded_s",
             "comparer_checks", "comparer_mismatches", "oversubscription", "checks")
COMPARER_EVERY_N = 8
WARM_BUCKETS = (16, 32, 64, 128)
# the relay death's cluster and measured pods: the degraded pods take the
# sequential path on the host, one pod at a time
RELAY_DEATH_NODES = 1000
RELAY_DEATH_PODS = 256


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


class _WarmCheck:
    """Stands in for ``batch.fused_step_batch`` during the warm sweep
    (``armed``): each
    launch on the card keeps copies of its inputs and outputs (on the card,
    so the sweep's timed runs stay clean of the plain version), and
    ``verify`` holds each against ``fused_step_batch_ref`` on the same
    inputs, every output bit for bit (the plain version launches nothing)."""

    def __init__(self):
        self.inner = batch.fused_step_batch
        self.launches = []  # (inputs, outputs) of each launch on the card

    @contextlib.contextmanager
    def armed(self):
        """Stand in for the fused step only while ``warm_buckets`` runs, so
        the measured phase launches the kernel unwrapped."""
        warm = tpu_scheduler.TPUScheduler.warm_buckets

        def checked(sched, *args, **kw):
            batch.fused_step_batch = self
            try:
                return warm(sched, *args, **kw)
            finally:
                batch.fused_step_batch = self.inner

        tpu_scheduler.TPUScheduler.warm_buckets = checked
        try:
            yield
        finally:
            tpu_scheduler.TPUScheduler.warm_buckets = warm

    def __call__(self, *args):
        out = self.inner(*args)
        if args[0].device.type == "cuda":
            copy = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            self.launches.append((copy, [t.clone() for t in out]))
        return out

    @property
    def pods(self) -> list:
        return [args[4].shape[0] for args, _out in self.launches]

    def verify(self) -> None:
        for args, out in self.launches:
            ref = fused_step.fused_step_batch_ref(*args)
            for name, got, want in zip(ref._fields, out, ref):
                if not torch.equal(_bits(got), _bits(want)):
                    raise AssertionError(f"warm launch at P={args[4].shape[0]}: {name} "
                                         "differs from the plain version")


def _check_warm_sweep(run: dict, check: _WarmCheck) -> None:
    """Every launch of the sweep was kept, one per warm launch, at every
    bucket, each equal to the plain version."""
    check.verify()
    if (len(check.launches) != run["warm_launches"] or not run["warm_launches"]
            or sorted(set(check.pods)) != list(WARM_BUCKETS)):
        raise AssertionError(f"warm sweep: {run['warm_launches']} warm launches, checked "
                             f"at P={check.pods}")


def _check_relay_death(name: str, gpu: dict, cpu: dict) -> None:
    """The relay death on the card: every step and placement equal to the
    CPU loop's; pods degraded while the breaker was open; while it was
    open, no batch dispatched, no fused launch and no mirror; the probe
    launched the kernel and closed it."""
    strip = [[{k: v for k, v in st.items() if k != "launches"} for st in run["steps"]]
             for run in (gpu, cpu)]
    _check_loop_same(f"{name} relay death", {**gpu, "steps": strip[0]},
                     {**cpu, "steps": strip[1]}, ("steps", "placed", "faults", "degraded_s",
                                                   "relay_degraded_pods", "fallback_scheduled"))
    steps = gpu["steps"]
    opened = [st for st in steps if st["state"] == "open"]
    if (not gpu["relay_degraded_pods"] or len(opened) != 3 or steps[-1]["state"] != "closed"
            or len({(st["batches"], st["launches"]) for st in opened}) != 1
            or any(st["mirror"] for st in opened)
            or steps[-1]["launches"] <= opened[-1]["launches"]):
        raise AssertionError(f"{name} relay death on the card: {steps}")


def loop_faults_phase(loop: dict) -> dict:
    """The loop's failure model on the card: SchedulingSoak/1000Nodes/
    NoGangs with the device flap and the comparer on the card and the CPU;
    the relay death at SchedulingBasic/1000Nodes, card against CPU, with
    pods degraded while the breaker is open; the ring at the 500 ms
    default deadline in turns, cold against warmed, each == the CPU loop's
    placements (the loop_basic phase's run), the first warmed turn's sweep with
    every warm launch of the kernel against its plain version, and the
    mirror unchanged across every sweep."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    w = workloads.scheduling_soak(gangs=False)
    with _env(**RING):
        fused_step.LAUNCHES = 0
        gpu = workloads.run_loop_soak(w, "cuda", comparer_every_n=COMPARER_EVERY_N)
        if gpu["launches"] != fused_step.LAUNCHES:
            raise AssertionError(f"{w.name}: launches counted twice")
        t_cpu = time.perf_counter()
        cpu = workloads.run_loop_soak(w, "cpu", percentage=100,
                                      comparer_every_n=COMPARER_EVERY_N)
        cpu_s = time.perf_counter() - t_cpu
    _check_loop_same(f"{w.name} with the flap", gpu, cpu, FLAP_KEYS)
    _check_flap(w.name, gpu)
    off = sum(m == "off" for m in gpu["modes"])
    if (gpu["comparer_mismatches"] or not gpu["comparer_checks"] or gpu["oversubscription"]
            or gpu["launches"] != off or off != len(gpu["modes"])):
        raise AssertionError(f"{w.name} with the flap: {gpu['comparer_mismatches']} comparer "
                             f"mismatches in {gpu['comparer_checks']} checks, "
                             f"{gpu['oversubscription']} oversubscribed, {gpu['launches']} "
                             f"launches for {off} mode-off of {len(gpu['modes'])} batches")
    flips = [i for i in range(1, len(gpu["breaker"])) if gpu["breaker"][i] != gpu["breaker"][i - 1]]
    print(f"{w.name} through the loop with the device flap and the comparer every "
          f"{COMPARER_EVERY_N}th landed winner: {sum(gpu['bound'].values())} pods bound (per "
          f"tenant {gpu['bound']}) in {len(gpu['batch_pods'])} batches over {gpu['cycles']} "
          f"cycles; breaker state changes at cycles {flips}"
          + _flap_note(gpu) + f", {gpu['fallback_scheduled']} bound there; comparer "
          f"{gpu['comparer_checks']} checks, {gpu['comparer_mismatches']} mismatches; 0 "
          f"oversubscription at {gpu['checks']} checks; all == the cpu loop ({cpu_s:.1f} s); "
          f"{gpu['launches']} fused launches for {off} batches; {gpu['pods_per_s']:.1f} "
          f"pods/s over {gpu['soak_s']:.2f} s; attempt p50 {gpu['attempt_ms']['p50']:.2f} ms, "
          f"p99 {gpu['attempt_ms']['p99']:.2f} ms on the soak's clock")
    out[f"{w.name}/flap"] = {"launches": gpu["launches"], "run": gpu}
    part("flap soak")

    rw = workloads.scheduling_basic(RELAY_DEATH_NODES, RELAY_DEATH_NODES // 2, RELAY_DEATH_PODS)
    with _env(**RING):
        fused_step.LAUNCHES = 0
        gpu = workloads.run_relay_death(rw, "cuda", percentage=100)
        if gpu["launches"] > fused_step.LAUNCHES:
            raise AssertionError(f"{rw.name} relay death: launches counted twice")
        cpu = workloads.run_relay_death(rw, "cpu", percentage=100)
    _check_relay_death(rw.name, gpu, cpu)
    steps = gpu["steps"]
    print(f"{rw.name} relay death (threshold {workloads.RELAY_DEATH_THRESHOLD}, probe "
          f"{workloads.RELAY_DEATH_PROBE_S} s): {gpu['faults']} commits died, the breaker "
          f"per step {[st['state'] for st in steps]}; {gpu['relay_degraded_pods']} pods "
          f"arrived or retried while it was open and took the sequential path "
          f"({gpu['fallback_scheduled']} bound there), no batch dispatched, no fused launch "
          f"and no mirror on the card while open; the probe batch closed it "
          f"({steps[-1]['launches'] - steps[-2]['launches']} fused launches); "
          f"{gpu['degraded_s']:.2f} degraded s on the run's clock; steps and placements == the "
          f"cpu loop; {gpu['seconds']:.2f} s on the card, {cpu['seconds']:.2f} s on the cpu")
    out[f"{rw.name}/relay_death"] = {"launches": gpu["launches"], "run": gpu}
    part("relay death")

    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    cpu_basic = loop[CPU_BASIC]
    turns = {"cold": [], "warm": []}
    env = dict(RING, KTPU_BATCH_DEADLINE_MS=None)
    sweep = None
    for kind in ("cold", "warm", "warm", "cold"):
        label = f"{basic.name} [ring, default deadline, {kind}]"
        warm = kind == "warm"
        if warm and sweep is None:
            # the first warmed turn: every launch of the sweep is kept and
            # held against the plain version after the run
            check = _WarmCheck()
            with check.armed():
                run = sweep = _loop_run(basic, label, env, batch_deadline_ms=None, warm=True)
            _check_warm_sweep(run, check)
        else:
            run = _loop_run(basic, label, env, batch_deadline_ms=None, warm=warm)
        _check_all_bound(basic.name, basic, run)
        _check_loop_same(f"{basic.name} at the deadline", run, cpu_basic, ("placed",))
        if warm and (not run["mirror_unchanged"]
                     or run["warm_launches"] != sweep["warm_launches"]):
            raise AssertionError(f"{basic.name} warmed: {run['warm_launches']} warm launches, "
                                 f"the mirror unchanged: {run['mirror_unchanged']}")
        turns[kind].append(run)
    print(f"{basic.name} warm sweep (N=5120, the first warmed turn): {sweep['warmed']} programs "
          f"in {sweep['warm_s']:.3f} s (with the check's copies); {sweep['warm_launches']} fused "
          f"launches, each == fused_step_batch_ref bit for bit (P = {check.pods}); the mirror's "
          f"tensors unchanged across the sweep")
    for kind, runs in turns.items():
        for i, run in enumerate(runs):
            sizes = {}
            for n in run["batch_pods"]:
                sizes[n] = sizes.get(n, 0) + 1
            print(f"{basic.name} at the default deadline (500 ms), {kind} {i + 1}: "
                  f"{run['pods_per_s']:.1f} pods/s, attempt p50 {run['attempt_ms']['p50']:.2f} "
                  f"ms, p99 {run['attempt_ms']['p99']:.2f} ms; popped batch sizes "
                  f"{dict(sorted(sizes.items()))}; the measured phase's first batch ms per "
                  f"bucket "
                  + ", ".join(f"{b}: {ms:.2f}" for b, ms in sorted(run["first_batch_ms"].items()))
                  + (f"; the sweep {run['warmed']} programs in {run['warm_s']:.3f} s, "
                     f"{run['warm_launches']} launches, timed runs (bucket, ms) "
                     + ", ".join(f"({b}, {t * 1e3:.3f})" for b, t in run["warm_timings"])
                     + f", fitted a {run['warm_sizer']['a'] * 1e3:.3f} ms, b "
                     f"{run['warm_sizer']['b'] * 1e3:.5f} ms per pod (wait a "
                     f"{run['warm_sizer']['wa'] * 1e3:.3f}, b {run['warm_sizer']['wb'] * 1e3:.5f}"
                     f"), target {run['warm_sizer']['target']}" if kind == "warm" else "")
                  + "; placements == the cpu loop")
    out[f"{basic.name}/deadline"] = {"launches": turns["cold"][0]["launches"],
                                     "run": turns["cold"]}
    out[f"{basic.name}/deadline_warm"] = {"launches": turns["warm"][0]["launches"],
                                          "run": turns["warm"]}
    out["warm_launches"] = sweep["warm_launches"]
    part("deadline turns")
    print("loop_faults phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return out


# ---------------------------------------------------------------- loop_profiles phase

PROFILE_CUSTOM_NODES, PROFILE_CUSTOM_INIT, PROFILE_CUSTOM_PODS = 1000, 500, 256


def loop_profiles_phase(loop: dict) -> dict:
    """The loop built from a KubeSchedulerConfiguration on the card and on
    the CPU: two batchable profiles at SchedulingBasic/5000Nodes, the custom
    profiles at SchedulingBasic/1000Nodes, PreemptionBasic/500Nodes with
    PriorityClasses (against the loop_basic phase's numeric runs)."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    names = ("default-scheduler", "batch-b")
    config = workloads.profiles_config(*names)
    basic = workloads.with_scheduler_names(workloads.scheduling_basic(N_NODES, N_PODS, N_PODS),
                                           names)
    gpu = _loop_run(basic, f"{basic.name} [two profiles, ring]", RING, config=config)
    with _env(**RING):
        cpu = workloads.run_loop(basic, "cpu", percentage=100, config=config)
    _check_all_bound(basic.name, basic, gpu)
    if (set(gpu["paths"]) != {"fused"} or gpu["launches"] != gpu["batches"]
            or gpu["fallback_scheduled"]):
        raise AssertionError(f"{basic.name} [two profiles]: paths {set(gpu['paths'])}, "
                             f"{gpu['launches']} launches for {gpu['batches']} batches, "
                             f"{gpu['fallback_scheduled']} sequential binds")
    if gpu["scheduled_by_profile"] != {"default-scheduler": N_PODS // 2, "batch-b": N_PODS // 2}:
        raise AssertionError(f"{basic.name} [two profiles]: {gpu['scheduled_by_profile']}")
    _check_loop_same(f"{basic.name} [two profiles]", gpu, cpu, ("placed", "cycles", "paths"))
    print(f"{basic.name} with profiles {list(names)} (measured pods alternating): every batch "
          f"on the fused kernel, {gpu['launches']} launches for {gpu['batches']} batches, 0 "
          f"sequential binds, placements == the cpu loop of the same config; "
          f"{gpu['pods_per_s']:.1f} pods/s; attempt p99 per profile "
          + ", ".join(f"{k} {v['p99']:.2f} ms" for k, v in gpu["attempt_ms_by_profile"].items())
          + " (the loop_basic phase's one-profile ring runs: "
          + " / ".join(f"{r['pods_per_s']:.1f}" for r in loop[f"{basic.name}/ring"]["run"])
          + " pods/s)")
    out[f"{basic.name}/profiles"] = {"launches": gpu["launches"], "run": gpu}
    part("two profiles")

    names = ("default-scheduler", "most-allocated", "default-scheduler", "no-scoring")
    config = workloads.profiles_config("default-scheduler", "most-allocated", "no-scoring")
    custom = workloads.with_scheduler_names(workloads.scheduling_basic(
        PROFILE_CUSTOM_NODES, PROFILE_CUSTOM_INIT, PROFILE_CUSTOM_PODS), names)
    gpu = _loop_run(custom, f"{custom.name} [custom profiles, ring]", RING, config=config,
                    percentage=100)
    with _env(**RING):
        cpu = workloads.run_loop(custom, "cpu", percentage=100, config=config)
    _check_all_bound(custom.name, custom, gpu)
    n_custom = PROFILE_CUSTOM_PODS // 2
    if (gpu["fallback_scheduled"] != n_custom or gpu["launches"] != gpu["batches"]
            or set(gpu["paths"]) != {"fused"}
            or sum(gpu["batch_pods"]) != PROFILE_CUSTOM_INIT + PROFILE_CUSTOM_PODS - n_custom):
        raise AssertionError(f"{custom.name} [custom profiles]: {gpu['fallback_scheduled']} "
                             f"sequential binds, {gpu['launches']} launches for "
                             f"{gpu['batches']} batches of {sum(gpu['batch_pods'])} pods")
    _check_loop_same(f"{custom.name} [custom profiles]", gpu, cpu,
                     ("placed", "cycles", "fallback_scheduled", "batch_pods"))
    print(f"{custom.name} with profiles most-allocated and no-scoring: {n_custom} custom pods "
          f"bound by the sequential path, {sum(gpu['batch_pods'])} pods in {gpu['batches']} "
          f"batches on the fused kernel ({gpu['launches']} launches), placements == the cpu "
          f"loop; {gpu['pods_per_s']:.1f} pods/s; attempt p99 per profile "
          + ", ".join(f"{k} {v['p99']:.2f} ms" for k, v in gpu["attempt_ms_by_profile"].items()))
    out[f"{custom.name}/custom_profiles"] = {"launches": gpu["launches"], "run": gpu}
    part("custom profiles")

    pre = workloads.preemption_basic(classes=True)
    gpu = _loop_run(pre, f"{pre.name} [priority classes, inline ring]", RING,
                    config=workloads.profiles_config("default-scheduler"))
    preemptors = [k for k in gpu["placed"] if "/preemptor-" in k or "/warm-" in k]
    if not all(gpu["placed"][k] for k in preemptors) or gpu["settle_abandoned"]:
        raise AssertionError(f"{pre.name} [priority classes]: a preemptor is unbound")
    numeric = loop[f"{pre.name}/inline"]["run"]
    _check_loop_same(f"{pre.name} [priority classes]", gpu, loop[CPU_PREEMPT],
                     ("placed", "preempted", "nominations", "cycles", "metrics"))
    _check_loop_same(f"{pre.name} [priority classes] against the numeric card run", gpu,
                     numeric, ("placed", "preempted", "nominations", "cycles", "metrics"))
    print(f"{pre.name} with PriorityClasses low (1) and high (100): {len(preemptors)} "
          f"preemptors bound, {len(gpu['preempted'])} victims, {len(gpu['nominations'])} "
          f"nominations, all == the cpu loop's and the card's numeric-priority runs of the "
          f"loop_basic phase; {gpu['launches']} launches for {gpu['batches']} batches")
    out[f"{pre.name}/classes"] = {"launches": gpu["launches"], "run": gpu}
    part("priority classes")
    print("loop_profiles phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; total {sum(parts.values()):.1f}")
    return out


# ---------------------------------------------------------------- loop_admission phase

ADMISSION_PAIRS = 2  # the chain's cost: chain on / off in turns
EXT_NODES, EXT_INIT, EXT_PODS, WIRE_PODS = 1000, 500, 256, 64
EXT_NAMES = ("default-scheduler",) * 3 + ("no-scoring",)


def _extenders(made: list, nodes: int, bind: bool = True, preempt: bool = False):
    """``run_loop``'s ``extenders``: one ``LoopExtender`` binding through
    the run's store (appended to ``made``)."""
    def make(store):
        made.append(workloads.LoopExtender(nodes, store.bind if bind else None, preempt=preempt))
        return made[-1:]
    return make


def _check_calls(name: str, got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{name}: extender calls {got} differ from {what}'s {want}")


def loop_admission_phase(loop: dict) -> dict:
    """The store's admission chain and the scheduler extenders through the
    loop on the card, each run against the CPU loop: SchedulingBasic/
    5000Nodes with the chain doing the work (``workloads.admission_basic``);
    the chain's cost, SchedulingBasic/5000Nodes with the chain and
    validation on and off in turns; SchedulingBasic/1000Nodes with an
    in-process extender and a quarter of the pods on ``no-scoring``;
    PreemptionBasic/500Nodes with a preempt-capable extender; the same
    extender behind a local HTTP server against its in-process run."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    w = workloads.admission_basic(N_NODES, N_PODS, N_PODS)
    gpu = _loop_run(w, f"{w.name} [inline ring]", RING)
    with _env(**RING):
        cpu = workloads.run_loop(w, "cpu", percentage=100)
    _check_loop_same(w.name, gpu, cpu, ("placed", "cycles", "metrics", "refused",
                                        "refused_pods", "quota_used", "admitted"))
    team_c = workloads.ADMISSION_TENANTS[3]
    want_refused = {"ResourceQuota": N_PODS // len(workloads.ADMISSION_TENANTS)
                    - team_c.quota_pods}
    if (gpu["refused"] != want_refused or not all(gpu["placed"].values())
            or set(gpu["paths"]) != {"fused"} or gpu["launches"] != gpu["batches"]):
        raise AssertionError(f"{w.name}: refused {gpu['refused']}, paths {set(gpu['paths'])}, "
                             f"{gpu['launches']} launches for {gpu['batches']} batches")
    broken = workloads.admission_violations(w, gpu)
    if broken:
        raise AssertionError(f"{w.name}: {broken[:5]}")
    n_ready = N_NODES - w.not_ready_nodes
    print(f"{w.name}: {len(gpu['placed'])} pods bound, creates refused per plugin "
          f"{gpu['refused']}, no pod on the {w.not_ready_nodes} nodes created not Ready "
          f"(the {n_ready} others take them, the {w.unreachable_nodes[1] - w.unreachable_nodes[0]}"
          f" unreachable ones included), every team-a pod on pool=b, team-b's at the "
          f"LimitRange's 500m, team-c's at 900m + 250m overhead, ResourceQuota used "
          f"{gpu['quota_used']}; == the cpu loop (placements, refusals, counters); "
          f"{gpu['launches']} launches for {gpu['batches']} batches; {gpu['pods_per_s']:.1f} "
          f"pods/s; the measured creates {gpu['measured_create_ms']:.2f} ms")
    out[w.name] = {"launches": gpu["launches"], "run": gpu}
    part("admission")

    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    turns = {"chain": [], "none": []}
    for i in range(ADMISSION_PAIRS):
        for kind in ("chain", "none"):
            run = _loop_run(basic, f"{basic.name} [{kind} {i + 1}]", RING,
                            admission=kind == "chain")
            _check_all_bound(basic.name, basic, run)
            _check_loop_same(f"{basic.name} [{kind}]", run, loop[CPU_BASIC], ("placed", "cycles"))
            turns[kind].append(run)
    med = {k: statistics.median(r["pods_per_s"] for r in v) for k, v in turns.items()}
    create_us = {k: statistics.median(r["measured_create_ms"] for r in v) * 1e3 / N_PODS
                 for k, v in turns.items()}
    print(f"{basic.name}, the admission chain and validation on / off in turns "
          f"({ADMISSION_PAIRS} pairs, inline ring): median "
          f"{med['chain']:.1f} / {med['none']:.1f} pods/s (each: "
          + " / ".join(f"{r['pods_per_s']:.1f}" for r in turns["chain"]) + " against "
          + " / ".join(f"{r['pods_per_s']:.1f}" for r in turns["none"])
          + f"); a measured create {create_us['chain']:.2f} / {create_us['none']:.2f} us, the "
          f"chain's share {create_us['chain'] - create_us['none']:.2f} us per create; placements "
          "== the loop_basic phase's cpu run either way")
    out[f"{basic.name}/chain"] = {"launches": turns["chain"][-1]["launches"],
                                  "pods_per_s": med, "create_us": create_us}
    part("cost")

    ext_w = workloads.extender_basic(EXT_NODES, EXT_INIT, EXT_PODS, EXT_NAMES)
    config = workloads.profiles_config("default-scheduler", "no-scoring")
    made = []
    gpu = _loop_run(ext_w, f"{ext_w.name} [extender, ring]", RING, config=config,
                    percentage=100, extenders=_extenders(made, EXT_NODES))
    with _env(**RING):
        cpu = workloads.run_loop(ext_w, "cpu", percentage=100, config=config,
                                 extenders=_extenders(made, EXT_NODES))
    _check_all_bound(ext_w.name, ext_w, gpu)
    _check_loop_same(ext_w.name, gpu, cpu, ("placed", "cycles", "fallback_scheduled",
                                            "batch_pods", "metrics"))
    _check_calls(ext_w.name, made[0].calls, made[1].calls, "the cpu run")
    measured = [p.key() for p in ext_w.measured_pod_list()]
    sequential = [k for i, k in enumerate(measured) if EXT_NAMES[i % 4] == "no-scoring"]
    batch_pods = [k for k in gpu["placed"] if k not in sequential]
    if (made[0].calls["bind"] != len(gpu["placed"]) or gpu["fallback_scheduled"] != len(sequential)
            or any(workloads.filtered_by_extender(gpu["placed"][k]) for k in sequential)):
        raise AssertionError(f"{ext_w.name}: calls {made[0].calls}, "
                             f"{gpu['fallback_scheduled']} sequential binds")
    c22 = sum(workloads.filtered_by_extender(gpu["placed"][k]) for k in batch_pods)
    upper = sum(int(gpu["placed"][k].rsplit("-", 1)[1]) >= EXT_NODES // 2 for k in sequential)
    print(f"{ext_w.name} with a LoopExtender (Filter drops node-i, i % "
          f"{workloads.EXTENDER_FILTER_MOD} == 0; Prioritize {workloads.EXTENDER_POOL_SCORE} "
          f"to pool=b at weight {workloads.EXTENDER_WEIGHT}; Bind through the store): calls "
          f"{made[0].calls} == the cpu run's, placements == the cpu loop; every one of "
          f"{len(gpu['placed'])} pods bound through the extender; {len(sequential)} sequential "
          f"pods, none on a filtered node, {upper} on pool=b; {c22} of {len(batch_pods)} batch "
          f"pods on filtered nodes (ROADMAP C22: the batch meets no Filter); "
          f"{gpu['pods_per_s']:.1f} pods/s; attempt p99 per profile "
          + ", ".join(f"{k} {v['p99']:.2f} ms" for k, v in gpu["attempt_ms_by_profile"].items()))
    out[f"{ext_w.name}"] = {"launches": gpu["launches"], "run": gpu}
    part("extender")

    pre = workloads.preemption_basic()
    made = []
    gpu = _loop_run(pre, f"{pre.name} [preempting extender, inline ring]", RING, percentage=100,
                    extenders=_extenders(made, pre.nodes, bind=False, preempt=True))
    with _env(**RING):
        cpu = workloads.run_loop(pre, "cpu", percentage=100,
                                 extenders=_extenders(made, pre.nodes, bind=False, preempt=True))
    _check_loop_same(f"{pre.name} [preempting extender]", gpu, cpu,
                     ("placed", "preempted", "nominations", "cycles", "metrics"))
    _check_calls(pre.name, made[0].calls, made[1].calls, "the cpu run")
    preemptors = [k for k in gpu["placed"] if "/preemptor-" in k or "/warm-" in k]
    if not all(gpu["placed"][k] for k in preemptors) or not made[0].calls["preempt"]:
        raise AssertionError(f"{pre.name} [preempting extender]: a preemptor is unbound")
    print(f"{pre.name} with a preempt-capable extender (every other candidate node kept): "
          f"{made[0].calls['preempt']} ProcessPreemption calls, {len(gpu['preempted'])} victims, "
          f"{len(gpu['nominations'])} nominations, all == the cpu loop; {len(preemptors)} "
          f"preemptors bound; {gpu['launches']} launches for {gpu['batches']} batches; "
          f"{gpu['pods_per_s']:.1f} pods/s")
    out[f"{pre.name}/extender"] = {"launches": gpu["launches"], "run": gpu}
    part("preempting extender")

    wire_w = workloads.extender_basic(EXT_NODES, EXT_INIT, WIRE_PODS, ("no-scoring",))
    made = []
    local = _loop_run(wire_w, f"{wire_w.name} [in-process extender]", RING, config=config,
                      percentage=100, extenders=_extenders(made, EXT_NODES, preempt=True))
    stores = []
    ext = workloads.LoopExtender(EXT_NODES, lambda key, node: stores[-1].bind(key, node),
                                 preempt=True)
    server, url = workloads.serve_extender(ext)
    try:
        wired = _loop_run(wire_w, f"{wire_w.name} [HTTP extender]", RING, percentage=100,
                          config=dict(config, extenders=[workloads.extender_config(url)]),
                          extenders=lambda store: stores.append(store) or [])
    finally:
        server.shutdown()
        server.server_close()
    _check_loop_same(f"{wire_w.name} [HTTP extender]", wired, local,
                     ("placed", "cycles", "fallback_scheduled", "metrics"))
    _check_calls(wire_w.name, ext.calls, made[0].calls, "the in-process run")
    posts = wired["extender_post_ms"]
    if sorted(posts) != ["bind", "filter", "prioritize"]:
        raise AssertionError(f"{wire_w.name} [HTTP extender]: POSTs {sorted(posts)}")
    print(f"{wire_w.name}, {WIRE_PODS} pods on no-scoring, the extender behind "
          f"ThreadingHTTPServer on 127.0.0.1 (HTTPExtender from the config's urlPrefix, four "
          f"verbs): placements and calls {ext.calls} == the in-process run; ms per POST "
          + ", ".join(f"{v} median {statistics.median(ms):.3f} (min {min(ms):.3f}, max "
                      f"{max(ms):.3f}, {len(ms)} POSTs)" for v, ms in sorted(posts.items()))
          + f"; {wired['pods_per_s']:.1f} against {local['pods_per_s']:.1f} pods/s in process")
    out[f"{wire_w.name}/http"] = {"launches": wired["launches"], "run": wired,
                                  "post_ms": posts}
    part("wire")
    print("loop_admission phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; total {sum(parts.values()):.1f}")
    return out


TELEMETRY_PAIRS = 2  # the recorders' cost: off / on in turns
BORROW_NODES, BORROW_ROUNDS, BORROW_SCALE = 1000, 8, 100
BORROW_KEYS = ("placed", "invariants", "tenants", "e2e", "batch_pods", "evicted", "reclaims",
               "cycles")


def _segment_medians(entries) -> dict:
    segs: dict = {}
    for e in entries:
        for seg, v in e["segments"].items():
            segs.setdefault(seg, []).append(v)
    return {seg: statistics.median(v) for seg, v in sorted(segs.items())}


def _check_observed(name: str, run: dict) -> dict:
    """The recorders' checks on one observed run; returns its numbers."""
    o = run["observed"]
    fused = {k: v for k, v in o["programs"].items() if k.startswith("schedule_batch@")}
    count = sum(v["count"] for v in fused.values())
    if not (count == o["launches"] == run["launches"] == run["batches"]):
        raise AssertionError(f"{name}: {count} schedule_batch records, {o['launches']} launches "
                             f"observed, {run['launches']} counted, {run['batches']} batches")
    if o["retraces"] != 0:
        raise AssertionError(f"{name}: {o['retraces']} retraces")
    if o["e2e_rel_err"] > 1e-9 or o["live"]:
        raise AssertionError(f"{name}: e2e against its segments {o['e2e_rel_err']:.3g} "
                             f"relative, {o['live']} entries open")
    scheduled = [e for e in o["entries"] if e["result"] == "scheduled"]
    if len(scheduled) != run["metrics"]["scheduled"] or len(o["entries"]) != len(run["placed"]):
        raise AssertionError(f"{name}: {len(scheduled)} entries closed scheduled for "
                             f"{run['metrics']['scheduled']} pods bound")
    if o["cycles"] != run["batches"] or o["waits"] != run["batches"] or o["phase_gap_ns"]:
        raise AssertionError(f"{name}: {o['cycles']} cycle spans and {o['waits']} waits for "
                             f"{run['batches']} batches, phase gap {o['phase_gap_ns']} ns")
    if len(o["device_exec_s"]) != run["batches"] or not all(t > 0 for t in o["device_exec_s"]):
        raise AssertionError(f"{name}: deviceExecS {o['device_exec_s']}")
    if sorted(o["hbm"]) != ["bytes_in_use", "bytes_limit", "peak_bytes_in_use", "peak_ever"]:
        raise AssertionError(f"{name}: device memory sample {o['hbm']}")
    recs = [r for r in o["records"] if r["program"] == "schedule_batch"]
    measured = [e["e2e"] for e in scheduled if "/measured-" in e["pod"]]
    return {
        "device_exec_ms": statistics.median(o["device_exec_s"]) * 1e3,
        "phases_ms": {p: statistics.median(r[f"{p}S"] for r in recs) * 1e3
                      for p in ("dwell", "exec", "fetch", "wait")},
        "busy_share": o["busy_share"], "transfer": o["transfer"],
        "hbm_peak": o["hbm"]["peak_ever"], "compilations": o["compilations"],
        "e2e_ms": {q: float(np.quantile(measured, q / 100)) * 1e3 for q in (50, 99)},
        "segments_ms": {k: v * 1e3 for k, v in _segment_medians(scheduled).items()},
        "wait_uncovered_us": o["wait_uncovered_us"], "events": o["events"],
        "cost": {k: v.get("bytesAccessed") for k, v in fused.items()},
    }


def loop_telemetry_phase(loop: dict, kern: dict) -> dict:
    """Device telemetry, the latency ledger and tracing through the loop on
    the card: SchedulingBasic/5000Nodes with the recorders off and on in
    turns, each == the CPU loop and on == off, the dispatch ledger, the
    ledger's segments and the spans checked on every observed run; then
    SchedulingBorrow/1000Nodes, both arms, on the card == the CPU."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    turns = {"off": [], "on": []}
    for i in range(TELEMETRY_PAIRS):
        for kind in ("off", "on"):
            run = _loop_run(basic, f"{basic.name} [recorders {kind} {i + 1}]", RING,
                            observe=kind == "on")
            _check_all_bound(basic.name, basic, run)
            _check_loop_same(f"{basic.name} [recorders {kind}]", run, loop[CPU_BASIC],
                             ("placed", "cycles"))
            _check_loop_same(f"{basic.name} [recorders {kind} against off]", run,
                             turns["off"][0] if turns["off"] else run,
                             ("placed", "cycles", "batch_pods", "metrics", "paths"))
            turns[kind].append(run)
    obs = [_check_observed(f"{basic.name} [recorders on {i + 1}]", r)
           for i, r in enumerate(turns["on"])]
    med = {k: statistics.median(r["pods_per_s"] for r in v) for k, v in turns.items()}
    p99 = {k: statistics.median(r["attempt_ms"]["p99"] for r in v) for k, v in turns.items()}
    print(f"{basic.name}, the three recorders off / on in turns ({TELEMETRY_PAIRS} pairs, "
          f"inline ring): median {med['off']:.1f} / {med['on']:.1f} pods/s (each: "
          + " / ".join(f"{r['pods_per_s']:.1f}" for r in turns["off"]) + " against "
          + " / ".join(f"{r['pods_per_s']:.1f}" for r in turns["on"])
          + f"); attempt p99 {p99['off']:.2f} / {p99['on']:.2f} ms; placements == the "
          "cpu loop, on == off")
    for i, o in enumerate(obs):
        t = o["transfer"]
        nbytes = o["cost"][f"schedule_batch@{P}/off"]  # the cost ledger's, from the shapes
        print(f"{basic.name} [recorders on {i + 1}]: {turns['on'][i]['batches']} schedule_batch "
              f"records == {turns['on'][i]['launches']} fused launches; deviceExecS median "
              f"{o['device_exec_ms']:.4f} ms per batch program (the kernel alone "
              f"{kern['ms']:.4f} ms in the kernel phase); the wait's dwell / exec / fetch / "
              "whole medians " + " / ".join(f"{v:.4f}" for v in o["phases_ms"].values())
              + f" ms; the fused step's {nbytes:.0f} bytes over the median deviceExecS "
              f"{nbytes / (o['device_exec_ms'] / 1e3) / 1e9:.1f} GB/s = "
              f"{nbytes / (o['device_exec_ms'] / 1e3) / HBM_BYTES_PER_S * 100:.2f}% of 3.35 "
              f"TB/s (over the kernel's ms: {nbytes / (kern['ms'] / 1e3) / HBM_BYTES_PER_S * 100:.2f}"
              f"%); the card busy {o['busy_share'] * 100:.3f}% of the measured phase; uploads "
              f"{t['uploads']} of {t['uploadBytes']} bytes, fetches {t['fetches']} of "
              f"{t['fetchBytes']} bytes, allocator peak {o['hbm_peak']} bytes; builds "
              f"{o['compilations']} (the library was built before the phase), retraces 0; "
              f"ledger: every e2e == its segments' sum, measured e2e p50 "
              f"{o['e2e_ms'][50]:.2f} / p99 {o['e2e_ms'][99]:.2f} ms, segment medians "
              + ", ".join(f"{k} {v:.3f}" for k, v in o["segments_ms"].items())
              + f" ms; one scheduling.cycle span per batch, the dispatch phases end to end "
              f"in each wait (its own bookkeeping after them at most "
              f"{o['wait_uncovered_us']:.1f} us); flight events {o['events']}")
    out[f"{basic.name}/recorders"] = {"launches": turns["on"][-1]["launches"],
                                      "pods_per_s": med, "p99_ms": p99, "observed": obs}
    part("recorders")

    arms = {}
    for borrowing in (True, False):
        w = workloads.scheduling_borrow(BORROW_NODES, BORROW_ROUNDS, BORROW_SCALE,
                                        borrowing=borrowing)
        with _env(**RING):
            fused_step.LAUNCHES = 0
            gpu = workloads.run_loop_borrow(w, "cuda", percentage=100)
            if gpu["launches"] != fused_step.LAUNCHES:
                raise AssertionError(f"{w.name}: launches counted twice")
            cpu = workloads.run_loop_borrow(w, "cpu", percentage=100)
        _check_loop_same(w.name, gpu, cpu, BORROW_KEYS)
        inv = gpu["invariants"]
        if inv["OversubscriptionViolations"] != 0 or (borrowing and inv["Reclaims"] <= 0):
            raise AssertionError(f"{w.name}: invariants {inv}")
        if set(gpu["paths"]) != {"fused"} or gpu["launches"] != len(gpu["paths"]):
            raise AssertionError(f"{w.name}: paths {set(gpu['paths'])}, {gpu['launches']} "
                                 f"launches for {len(gpu['paths'])} batches")
        arms[borrowing] = (w, gpu, cpu)
    on, off = arms[True][1]["invariants"], arms[False][1]["invariants"]
    lift = on["PoolUtilizationMean"] - off["PoolUtilizationMean"]
    if not lift > 0.10:
        raise AssertionError(f"SchedulingBorrow: utilization lift {lift:.4f} <= 0.10")
    for borrowing, (w, gpu, cpu) in arms.items():
        lender = gpu["tenants"]["borrow-lender"]
        print(f"{w.name} through the loop (inline ring, FakeClock): == the cpu loop (placements, "
              f"per-tenant admissions, loans, reclaims, invariants, the ledger's per-tenant e2e); "
              f"invariants {gpu['invariants']}; admitted "
              + ", ".join(f"{ns} {t['Admitted']:.0f}" for ns, t in gpu["tenants"].items())
              + f"; {len(gpu['paths'])} batches, {gpu['launches']} fused launches; "
              f"{gpu['pods_per_s']:.1f} pods/s ({cpu['pods_per_s']:.1f} on the cpu); the "
              f"lender's e2e p99 {lender['E2eP99']:.3f} s on the FakeClock")
        out[w.name] = {"launches": gpu["launches"], "pods_per_s": gpu["pods_per_s"],
                       "lender_p99_s": lender["E2eP99"], "invariants": gpu["invariants"]}
    print(f"SchedulingBorrow/{BORROW_NODES}Nodes: pool utilization lift {lift:.4f} > 0.10, "
          f"{on['Reclaims']:.0f} reclaims, zero oversubscription in both arms")
    part("borrow")
    print("loop_telemetry phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; total {sum(parts.values()):.1f}")
    return out


ENTROPY_TOL = 1e-6  # packing_entropy on the card against its plain version
REPLAY_NODES = 500   # SchedulingReplay's JAX default
ELASTIC_NODES = 1000  # SchedulingElastic's JAX default
REPLAY_KEYS = ("placed", "invariants", "tenants", "e2e", "cycles", "evicted", "batch_pods")
ELASTIC_KEYS = ("placed", "invariants", "evicted", "nodes", "cycles", "batch_pods")


# tests/test_rebalance.py:338-340's knobs
REPLAY_TEST_KNOBS = {"cooldown_s": 1.0, "score_interval_s": 0.25, "entropy_high": 0.80,
                     "entropy_low": 0.60, "max_migrations_per_wave": 8}


def _replay_bar(name: str, on_run: dict, off_run: dict) -> None:
    """The JAX acceptance bar that holds on the loop in every mode: waves
    and migrations with the rebalancer on, none off, no pod and no
    uncordon pending, no tenant's p99 past 3x the /NoRebalance arm's +
    0.5 s (``tests/test_rebalance.py:363-394``). PackingEff is printed: on
    the batch loop its two arms differ by under 1e-7, either way."""
    on, off = on_run["invariants"], off_run["invariants"]
    bad = []
    if not (on["Waves"] > 0 and on["Migrations"] > 0 and off["Waves"] == 0):
        bad.append("waves")
    if on["PendingUncordons"] or on["PendingAtEnd"] or off["PendingAtEnd"]:
        bad.append("pending")
    for ns, t_off in off_run["tenants"].items():
        t_on = on_run["tenants"][ns]
        if t_on["E2eCount"] and t_off["E2eCount"] and \
                t_on["E2eP99"] > t_off["E2eP99"] * 3.0 + 0.5:
            bad.append(f"p99 {ns}")
    if on["TenantP99Max"] > off["TenantP99Max"] * 3.0 + 0.5:
        bad.append("p99 max")
    if bad:
        raise AssertionError(f"{name}: bar failed ({bad}): on {on}, off {off}")


def _basic_mirror() -> dict:
    """SchedulingBasic/5000Nodes' init pods settled through the loop on the
    card: the mirror's score inputs (N = 5120, R = 6)."""
    from kubernetes_tpu_torch.apiserver.store import Store
    from kubernetes_tpu_torch.controllers.rebalance import mirror_score_inputs
    from kubernetes_tpu_torch.utils.clock import FakeClock

    w = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    clock = FakeClock()
    store = Store(now_fn=clock)
    sched = tpu_scheduler.TPUScheduler(store, device="cuda", now_fn=clock, batch_deadline_ms=0,
                                       batch_size=workloads.LOOP_BATCH,
                                       percentage_of_nodes_to_score=100)
    for ni in w.node_infos():
        store.create_node(ni.node)
    for pod in w.init_pod_list():
        store.create_pod(pod)
    sched.run_until_settled()
    sched.close()
    return mirror_score_inputs(sched.state)


def _entropy_on_card(name: str, inputs: dict) -> dict:
    """``packing_entropy`` on the card against its plain version on the CPU
    on the same inputs (within ENTROPY_TOL); its CUDA-event ms (median of
    TIMED_LAUNCHES), the plain version's ms, its kernel launches per call
    (torch.profiler) and the least time for its bytes."""
    from kubernetes_tpu_torch.controllers.rebalance import packing_entropy
    from kubernetes_tpu_torch.ops.topology import log_f32

    req, valid = torch.from_numpy(inputs["requested"]), torch.from_numpy(inputs["valid"])
    cm, cp = packing_entropy(req, valid)
    dreq, dvalid = req.to("cuda"), valid.to("cuda")
    times, (gm, gp) = _event_ms(lambda: packing_entropy(dreq, dvalid))
    err = max(abs(float(gm) - float(cm)), float((gp.cpu() - cp).abs().max()))
    if not err <= ENTROPY_TOL:
        raise AssertionError(f"{name}: packing_entropy on the card off by {err} > {ENTROPY_TOL}")
    plain = []
    for _ in range(TIMED_LAUNCHES):
        t = time.perf_counter()
        packing_entropy(req, valid)
        plain.append((time.perf_counter() - t) * 1e3)
    prof = _profiled(packing_entropy, (dreq, dvalid), {})
    log_prof = _profiled(log_f32, (dreq,), {})  # called twice per score: [N, R] and a scalar
    n, r = req.shape
    nbytes = req.numel() * 4 + valid.numel() + (r + 1) * 4  # rows and mask in, scores out
    # launches are counted at the runtime call: after the loop phases the
    # profiler loses some of a short program's device records, never its
    # cudaLaunchKernel calls
    out = {"ms": statistics.median(times), "plain_ms": statistics.median(plain),
           "kernels": prof["launch_calls"], "max_abs_err": err,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "entropy": float(gm)}
    print(f"packing_entropy on {name} (N={n}, R={r}): |card - plain| {err:.3g} <= "
          f"{ENTROPY_TOL}; entropy {float(gm):.6f}; {out['ms']:.4f} ms on the card (median of "
          f"{TIMED_LAUNCHES} CUDA-event timings), {prof['launch_calls']} kernel launches per "
          f"call ({log_prof['launch_calls']} in one log_f32 over the rows; the profiler's "
          f"device records {prof['kernels']} / {log_prof['kernels']}), device "
          f"busy {prof['device_ms']:.4f} ms; the plain version {out['plain_ms']:.4f} ms on the "
          f"cpu; its {nbytes} bytes take {out['bound_ms']:.6f} ms at 3.35 TB/s")
    return out


def loop_rebalance_phase() -> dict:
    """The drain orchestrator and the rebalancer through the loop on the
    card: ``packing_entropy`` on SchedulingBasic/5000Nodes' mirror and the
    replay's smeared mirror against its plain version; SchedulingReplay/
    500Nodes both arms and SchedulingElastic/1000Nodes, each == the CPU
    loop, with the JAX tests' bars."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    scores = {"SchedulingBasic/5000Nodes": _entropy_on_card("SchedulingBasic/5000Nodes",
                                                             _basic_mirror())}
    part("basic_mirror")
    arms = {}
    for rebalance in (True, False):
        w = workloads.scheduling_replay(REPLAY_NODES, rebalance=rebalance)
        with _env(**RING):
            fused_step.LAUNCHES = 0
            gpu = workloads.run_loop_replay(w, "cuda", percentage=100)
            if gpu["launches"] != fused_step.LAUNCHES:
                raise AssertionError(f"{w.name}: launches counted twice")
            cpu = workloads.run_loop_replay(w, "cpu", percentage=100)
        _check_loop_same(w.name, gpu, cpu, REPLAY_KEYS)
        for g, c in zip(gpu["waves"], cpu["waves"]):
            if {k: v for k, v in g.items() if k != "entropy"} != {
                    k: v for k, v in c.items() if k != "entropy"} \
                    or abs(g["entropy"] - c["entropy"]) > ENTROPY_TOL:
                raise AssertionError(f"{w.name}: wave {g} differs from the cpu's {c}")
        if len(gpu["waves"]) != len(cpu["waves"]):
            raise AssertionError(f"{w.name}: {len(gpu['waves'])} waves, cpu {len(cpu['waves'])}")
        arms[rebalance] = (w, gpu, cpu)
    on, off = arms[True][1]["invariants"], arms[False][1]["invariants"]
    _replay_bar(f"SchedulingReplay/{REPLAY_NODES}Nodes", arms[True][1], arms[False][1])
    scores[f"SchedulingReplay/{REPLAY_NODES}Nodes (smeared, end of trace)"] = _entropy_on_card(
        f"SchedulingReplay/{REPLAY_NODES}Nodes (smeared)", arms[True][1]["mirror"])
    for rebalance, (w, gpu, cpu) in arms.items():
        score_ms = [t * 1e3 for t in gpu["score_s"]]
        cpu_score_ms = [t * 1e3 for t in cpu["score_s"]]
        print(f"{w.name} through the loop (inline ring, FakeClock): == the cpu loop (placements, "
              f"invariants, waves and their victims, per-tenant e2e); invariants "
              f"{gpu['invariants']}; waves " + "; ".join(
                  f"{wv['nodes']} ({wv['evicted']} pods)" for wv in gpu["waves"])
              + f"; {len(gpu['batch_pods'])} batches, {gpu['launches']} fused launches, "
              f"{gpu['cycles']} cycles; {gpu['pods_per_s']:.1f} pods/s ({cpu['pods_per_s']:.1f} "
              f"on the cpu); the rebalancer's score inside the loop "
              + (f"{statistics.median(score_ms):.3f} ms per call (median of {len(score_ms)}; "
                 f"{statistics.median(cpu_score_ms):.3f} ms on the cpu)" if score_ms
                 else "never ran (off)")
              + f"; evicted {gpu['evicted']}")
        out[w.name] = {"launches": gpu["launches"], "pods_per_s": gpu["pods_per_s"],
                       "invariants": gpu["invariants"],
                       "score_ms": statistics.median(score_ms) if score_ms else None}
    # the JAX test's packing bar, in its own mode: one pod per cycle (the
    # sequential path) at its size, where the rebalancer gets the clock
    seq = {}
    for rebalance in (True, False):
        w = workloads.scheduling_replay(24, 6, 4, rebalance=REPLAY_TEST_KNOBS if rebalance
                                        else False)
        with _env(**RING):
            fused_step.LAUNCHES = 0
            gpu = workloads.run_loop_replay(w, "cuda", percentage=100, sequential=True)
            if gpu["launches"] != fused_step.LAUNCHES:
                raise AssertionError(f"{w.name} [sequential]: launches counted twice")
            cpu = workloads.run_loop_replay(w, "cpu", percentage=100, sequential=True)
        _check_loop_same(f"{w.name} [sequential]", gpu, cpu, REPLAY_KEYS)
        seq[rebalance] = gpu
        out[f"{w.name}/sequential"] = {"launches": gpu["launches"],
                                       "pods_per_s": gpu["pods_per_s"],
                                       "invariants": gpu["invariants"]}
    _replay_bar("SchedulingReplay/24Nodes [sequential]", seq[True], seq[False])
    s_on, s_off = seq[True]["invariants"], seq[False]["invariants"]
    if not (s_on["PackingEff"] > s_off["PackingEff"] + 0.005
            and s_on["FinalEntropy"] < s_off["FinalEntropy"]):
        raise AssertionError(f"SchedulingReplay/24Nodes [sequential]: packing not better: "
                             f"on {s_on}, off {s_off}")
    print(f"SchedulingReplay/24Nodes [sequential, one pod per cycle, the JAX test's knobs]: "
          f"== the cpu loop in both arms; waves {s_on['Waves']:.0f}, migrations "
          f"{s_on['Migrations']:.0f}, PackingEff {s_on['PackingEff']:.6f} on against "
          f"{s_off['PackingEff']:.6f} off (> +0.005), FinalEntropy {s_on['FinalEntropy']:.6f} / "
          f"{s_off['FinalEntropy']:.6f}, Suspended {s_on['Suspended']:.0f}; fused launches "
          f"{seq[True]['launches']} / {seq[False]['launches']} (on / off); "
          f"{seq[True]['pods_per_s']:.1f} / {seq[False]['pods_per_s']:.1f} pods/s; the score on "
          f"the card {statistics.median(seq[True]['score_s']) * 1e3:.3f} ms per call (the host "
          "snapshot's rows: no batch, no mirror)")
    print(f"SchedulingReplay/{REPLAY_NODES}Nodes: waves {on['Waves']:.0f}, migrations "
          f"{on['Migrations']:.0f}, PackingEff {on['PackingEff']:.9f} on against "
          f"{off['PackingEff']:.9f} off, FinalEntropy {on['FinalEntropy']:.6f} / "
          f"{off['FinalEntropy']:.6f}, TenantP99Max {on['TenantP99Max']:.4f} / "
          f"{off['TenantP99Max']:.4f} s; nothing pending, no uncordon pending")
    part("replay")

    w = workloads.scheduling_elastic(ELASTIC_NODES)
    with _env(**RING):
        fused_step.LAUNCHES = 0
        gpu = workloads.run_loop_elastic(w, "cuda", percentage=100)
        if gpu["launches"] != fused_step.LAUNCHES:
            raise AssertionError(f"{w.name}: launches counted twice")
        cpu = workloads.run_loop_elastic(w, "cpu", percentage=100)
    _check_loop_same(w.name, gpu, cpu, ELASTIC_KEYS)
    inv = gpu["invariants"]
    rows = float(tpu_scheduler.caps_for_cluster(ELASTIC_NODES).nodes)
    if (inv["LostPods"] or inv["Oversubscribed"] or inv["PendingAtEnd"]
            or not inv["SlotReuses"] > 0 or inv["RowCapacity"] != rows
            or inv["UploadBytesSteady"] != 0):
        raise AssertionError(f"{w.name}: invariants {inv}")
    print(f"{w.name} through the loop (inline ring, FakeClock): == the cpu loop (placements, "
          f"invariants, evictions, nodes); invariants {inv}; evicted by reason "
          f"{gpu['evicted']}; {len(gpu['batch_pods'])} batches, {gpu['launches']} fused "
          f"launches, {gpu['cycles']} cycles; {gpu['pods_per_s']:.1f} pods/s "
          f"({cpu['pods_per_s']:.1f} on the cpu)")
    out[w.name] = {"launches": gpu["launches"], "pods_per_s": gpu["pods_per_s"],
                   "invariants": inv, "evicted": gpu["evicted"]}
    part("elastic")
    out["packing_entropy"] = scores
    print("loop_rebalance phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; total {sum(parts.values()):.1f}")
    return out


# ---------------------------------------------------------------- loop_wire phase

# what a wire run of SchedulingBasic shares with the CPU loop's run of it
# (loop_basic_phase's CPU_BASIC: the wire equals the loop on the CPU,
# tests/test_torch_wire.py), and one of PreemptionBasic or of the restart
# with a CPU service's run
WIRE_LOOP_KEYS = ("placed", "batch_pods", "metrics", "pending")
WIRE_KEYS = WIRE_LOOP_KEYS + ("queued",)
WIRE_REPLICA_NODES = 1000  # the two-replica run
WIRE_RESTART = (500, 256, 512)  # the restart run's nodes, init and measured pods
WIRE_RESTART_AFTER = 3     # the restart comes after this many batches of its 6


def _wire_report(name: str, run: dict) -> None:
    split = ", ".join(f"{k} {v:.3f}" for k, v in run["wire_split_ms"].items() if v is not None)
    dev = ", ".join(f"{k} {v:.4f}" for k, v in run["device_time_ms"].items())
    att = run["attempt_ms"] or {}
    services = len(run.get("per_replica") or (None,))
    print(f"{name} through the {run['transport']} wire (depth {run['depth']}, "
          f"{run['replicas']} client(s), {services} service(s)): "
          f"{run['metrics']['scheduled']} pods bound, {run['client_batches']} batches sent, "
          f"{run['batches']} run on the service (paths {sorted(set(run['paths']))}), fused "
          f"launches {run['launches']}, replays {run['replays']}, resyncs {run['resyncs']}, "
          f"conflicts {run['conflicts']}; measured phase {run['pods_per_s']:.1f} pods/s over "
          f"{run['measured_s']:.3f} s; attempt ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in att.items())
          + f"; per measured batch (median ms): {split}; deviceTime (median ms): {dev}")


def _wire_run(w, label: str, device, depth: int, **kw) -> dict:
    fused_step.LAUNCHES = 0
    run = workloads.run_loop_wire(w, device, depth, **kw)
    if run["launches"] != fused_step.LAUNCHES:
        raise AssertionError(f"{label}: launches counted twice")
    if run["settle_abandoned"] or run["degraded_pods"] or run["double_binds"] \
            or run["over_capacity"] or run["placements"] != run["binds"]:
        raise AssertionError(f"{label}: settle abandoned, degraded pods, a bind of a bound "
                             f"pod, a node over capacity or placements != binds: "
                             f"{run['degraded_pods']}, {run['double_binds'][:5]}, "
                             f"{run['over_capacity'][:5]}, {run['placements']} placements, "
                             f"{run['binds']} binds")
    if device != "cpu":
        _wire_report(label, run)
    return run


def _check_wire_same(name: str, got: dict, want: dict, keys, ref: str = "cpu service") -> None:
    for key in keys:
        if got[key] != want[key]:
            raise AssertionError(f"{name} through the wire: {key} differs from the {ref}'s run")


def loop_wire_phase(loop: dict) -> dict:
    """The batched device service over HTTP on the card
    (``backend/service.py``): ``WireScheduler`` against
    ``serve(DeviceService(device="cuda"))`` on 127.0.0.1. SchedulingBasic
    is held against the CPU loop's run of the loop_basic phase
    (``loop[CPU_BASIC]``, percentage 100); PreemptionBasic (whose victims
    the wire's hints and the loop's screen choose differently at 500
    nodes) and the restart against a CPU service's run. At
    depth 3 the service runs the three batches in flight in the order
    their handler threads take its lock (ROADMAP C26), so placements are
    not compared there: every pod must bind, with the CPU's pods per batch,
    counters and queue."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    basic = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
    cpu = loop[CPU_BASIC]
    turns = {0: [], 3: []}
    moved = {0: [], 3: []}
    for depth in (0, 3, 3, 0):
        label = f"{basic.name} [depth {depth} {len(turns[depth]) + 1}]"
        gpu = _wire_run(basic, label, "cuda", depth)
        _check_wire_same(label, gpu, cpu, WIRE_LOOP_KEYS if depth == 0 else
                         WIRE_LOOP_KEYS[1:], "cpu loop")
        _check_all_bound(label, basic, gpu)
        if set(gpu["paths"]) != {"fused"} or not (
                gpu["launches"] == gpu["batches"] == gpu["client_batches"]):
            raise AssertionError(f"{label}: paths {set(gpu['paths'])}, {gpu['launches']} "
                                 f"launches, {gpu['batches']} batches run, "
                                 f"{gpu['client_batches']} sent")
        if gpu["replays"] or gpu["resyncs"] or gpu["conflicts"]:
            raise AssertionError(f"{label}: replays, resyncs or conflicts in a clean run")
        turns[depth].append(gpu)
        moved[depth].append(sum(1 for k, v in gpu["placed"].items() if v != cpu["placed"][k]))
    for depth, runs in turns.items():
        print(f"{basic.name} through the wire at depth {depth} in turns: pods/s "
              + " / ".join(f"{r['pods_per_s']:.1f}" for r in runs) + "; attempt p50 "
              + " / ".join(f"{r['attempt_ms']['p50']:.2f}" for r in runs) + ", p99 "
              + " / ".join(f"{r['attempt_ms']['p99']:.2f}" for r in runs) + " ms; pods placed "
              "elsewhere than the cpu loop " + " / ".join(str(n) for n in moved[depth]))
    print(f"{basic.name}: every wire run binds every pod with the cpu loop's pods per batch, "
          "counters and queue, at depth 0 its placements; one fused launch per batch, none "
          "replayed")
    for depth, runs in turns.items():
        out[f"{basic.name}/depth{depth}"] = {"launches": runs[0]["launches"], "run": runs}
    part("basic turns")

    pre = workloads.preemption_basic()
    p_cpu = _wire_run(pre, f"{pre.name} [cpu]", "cpu", 0, percentage=100)
    p_gpu = _wire_run(pre, f"{pre.name} [depth 0]", "cuda", 0)
    _check_wire_same(pre.name, p_gpu, p_cpu, WIRE_KEYS + ("nominations",))
    preemptors = [k for k in p_gpu["placed"] if "/preemptor-" in k or "/warm-" in k]
    if not all(p_gpu["placed"][k] for k in preemptors) or not p_gpu["nominations"]:
        raise AssertionError(f"{pre.name} through the wire: a preemptor unbound or no "
                             "nomination")
    if p_gpu["launches"] != p_gpu["batches"]:
        raise AssertionError(f"{pre.name}: {p_gpu['launches']} launches for "
                             f"{p_gpu['batches']} batches")
    print(f"{pre.name} through the wire: {len(preemptors)} preemptors bound, "
          f"{len(p_gpu['nominations'])} nominations from the card's screen hints, all == the "
          "cpu service's run")
    out[pre.name] = {"launches": p_gpu["launches"], "run": p_gpu}
    part("preemption")

    small = workloads.scheduling_basic(WIRE_REPLICA_NODES, N_PODS // 2, N_PODS // 2)
    two = _wire_run(small, f"{small.name} [2 replicas, depth 3]", "cuda", 3, replicas=2)
    n_pods = small.n_init + small.n_measured
    if not all(two["placed"].values()) or len(two["placed"]) != n_pods \
            or two["placements"] != n_pods:
        raise AssertionError(f"{small.name} [2 replicas]: not every pod bound, or "
                             f"{two['placements']} placements for {n_pods} pods")
    if not (two["conflicts"] == two["service_conflicts"] > 0):
        raise AssertionError(f"{small.name} [2 replicas]: conflicts {two['conflicts']} counted "
                             f"by the clients, {two['service_conflicts']} by the service")
    print(f"{small.name}, two replicas on one card service: every pod placed and bound once "
          f"({two['placements']} placements, {two['binds']} binds, none of a bound pod), no "
          f"node over capacity, {two['conflicts']} conflict verdicts requeued, "
          f"{two['batches']} batches run")
    out[f"{small.name}/replicas2"] = {"launches": two["launches"], "run": two}
    part("replicas")

    small = workloads.scheduling_basic(*WIRE_RESTART)
    r_cpu = _wire_run(small, f"{small.name} [cpu, restart]", "cpu", 0, percentage=100,
                      restart_after=WIRE_RESTART_AFTER)
    r_gpu = _wire_run(small, f"{small.name} [restart after {WIRE_RESTART_AFTER} batches]",
                      "cuda", 0, restart_after=WIRE_RESTART_AFTER)
    _check_wire_same(f"{small.name} [restart]", r_gpu, r_cpu, WIRE_KEYS)
    if not (r_gpu["resyncs"] == r_gpu["restarts"] == 1
            and r_gpu["launches"] == r_gpu["batches"] == r_gpu["client_batches"]):
        raise AssertionError(f"{small.name} [restart]: resyncs {r_gpu['resyncs']}, launches "
                             f"{r_gpu['launches']}, {r_gpu['batches']} batches run, "
                             f"{r_gpu['client_batches']} sent")
    print(f"{small.name} with a service restart after {WIRE_RESTART_AFTER} batches: one full "
          f"resync, {r_gpu['launches']} launches for {r_gpu['client_batches']} batches (none "
          "run twice), placements == the cpu service's run with the same restart")
    out[f"{small.name}/restart"] = {"launches": r_gpu["launches"], "run": r_gpu}
    part("restart")
    print("loop_wire phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; total {sum(parts.values()):.1f}")
    return out


FABRIC_NODES = 1000  # the fabric runs' SchedulingBasic size: 1000 nodes,
FABRIC_PODS = 500    # 500 init and 500 measured pods
FABRIC_KILL_AFTER = 3  # the primary is killed after this many batches
OUTAGE_PODS = 256    # the all-replicas-down run's init and measured pods
FABRIC_KEYS = WIRE_KEYS + ("client_batches",)


def _fabric_report(name: str, run: dict) -> None:
    att = run["attempt_ms"] or {}
    print(f"{name}: {run['metrics']['scheduled']} pods bound, failovers {run['failovers']}, "
          f"active replica {run['active']}, per replica (batches, fused launches) "
          + ", ".join(f"({r['batches']}, {r['launches']})" for r in run["per_replica"])
          + f"; failover {run['failover_ms']:.1f} ms from the kill to the end of the promoted "
          f"replica's first batch (mostly the configured retry sleeps and pod backoff), the "
          f"fabric's promotion {run['promote_ms']:.1f} ms from the error reaching it to the "
          f"flip; promote resync uploaded {run['promote_bytes']} row bytes; "
          f"replication bytes {run['replication_bytes']}; measured phase "
          f"{run['pods_per_s']:.1f} pods/s, attempt ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in att.items()))


def _check_fabric(label: str, run: dict, n_pods: int, card: bool = True) -> None:
    """One transient failover to the standby, every pod bound once, none
    run twice; on the card launches == the batches the replicas ran."""
    per = run["per_replica"]
    if run["failovers"] != {"transient": 1} or run["active"] != 1:
        raise AssertionError(f"{label}: failovers {run['failovers']}, active {run['active']}")
    if not (run["placements"] == run["binds"] == n_pods and all(run["placed"].values())):
        raise AssertionError(f"{label}: {run['placements']} placements, {run['binds']} binds "
                             f"for {n_pods} pods")
    if run["batches"] != run["client_batches"] or card and not (
            run["launches"] == run["batches"] == sum(r["launches"] for r in per)
            == sum(r["batches"] for r in per) and all(r["batches"] == r["launches"]
                                                      for r in per)):
        raise AssertionError(f"{label}: {run['launches']} launches, {run['batches']} batches "
                             f"run, {run['client_batches']} sent, per replica {per}")
    if run["replays"] or per[0]["batches"] != FABRIC_KILL_AFTER:
        raise AssertionError(f"{label}: a batch ran twice, or the primary ran "
                             f"{per[0]['batches']} batches")


def _check_outage(label: str, run: dict, n_pods: int, card: bool) -> None:
    """The breaker open with nothing dispatched while the replicas were
    down, the pods on the sequential path; after the heal the batched path
    on the replica that came back, one launch per batch."""
    out, healed = run["outage"], run["healed"]
    if not (out["breaker"] == "open" and out["degraded_pods"] == OUTAGE_PODS
            and out["batches"] == [0, 0] and out["launches"] == 0):
        raise AssertionError(f"{label}: while every replica was down: {out}")
    if healed["dispatched_open"] or out["dispatched_open"]:
        raise AssertionError(f"{label}: a batch was dispatched while the breaker was open")
    if not (healed["breaker"] == "closed" and healed["active"] == 1
            and healed["batches"][0] == 0 and healed["batches"][1] > 0
            and healed["failovers"] == {"transient": 1}
            and healed["degraded_pods"] == OUTAGE_PODS):
        raise AssertionError(f"{label}: after the heal: {healed}")
    if card and healed["launches"] != healed["batches"][1]:
        raise AssertionError(f"{label}: {healed['launches']} launches for "
                             f"{healed['batches'][1]} batches")
    if run["bound"] != n_pods:
        raise AssertionError(f"{label}: {run['bound']} of {n_pods} pods bound")


def loop_fabric_phase() -> dict:
    """The device fabric on the card (``backend/fabric.py``): one
    ``WireScheduler`` over two ``serve(DeviceService(device="cuda"))``
    replicas on 127.0.0.1. SchedulingBasic/1000Nodes with the primary killed
    after three batches, cold standbys and warm ones (the replicator on),
    each against the same script on two CPU services; all replicas down and
    one healed, against the CPU; and, when the machine has grpc and
    protobuf, SchedulingBasic/5000Nodes over gRPC beside HTTP against the
    CPU loop. Every CPU reference is this phase's own run."""
    out = {}
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    basic = workloads.scheduling_basic(FABRIC_NODES, FABRIC_PODS, FABRIC_PODS)
    n_pods = 2 * FABRIC_PODS
    kw = dict(fabric_replicas=2, kill_primary_after=FABRIC_KILL_AFTER)
    cpu = _wire_run(basic, f"{basic.name} [cpu fabric]", "cpu", 0, percentage=100, **kw)
    _check_fabric(f"{basic.name} [cpu fabric]", cpu, n_pods, card=False)
    runs = {}
    for mode, warm in (("cold", False), ("warm", True)):
        label = f"{basic.name} [fabric, {mode} standby, primary killed]"
        gpu = _wire_run(basic, label, "cuda", 0, standby_replication=warm, **kw)
        _check_fabric(label, gpu, n_pods)
        _check_wire_same(label, gpu, cpu, FABRIC_KEYS, "cpu fabric")
        if set(gpu["paths"]) != {"fused"}:
            raise AssertionError(f"{label}: paths {set(gpu['paths'])}")
        _fabric_report(label, gpu)
        runs[mode] = gpu
        out[f"{basic.name}/{mode}"] = {"launches": gpu["launches"], "run": gpu}
    cold, warm = runs["cold"], runs["warm"]
    if not (0 < warm["promote_bytes"] < cold["promote_bytes"]
            and warm["replication_bytes"].get("full", 0) > 0):
        raise AssertionError(f"warm standby: promote bytes {warm['promote_bytes']} against "
                             f"cold {cold['promote_bytes']}, replication "
                             f"{warm['replication_bytes']}")
    print(f"{basic.name}: the warm standby's promote resync uploaded {warm['promote_bytes']} "
          f"row bytes against the cold standby's full seed of {cold['promote_bytes']}; "
          f"standby_resync_bytes by kind {warm['replication_bytes']}; both runs == the cpu "
          "fabric's placements, counters and queue")
    part("failover")

    small = workloads.scheduling_basic(FABRIC_NODES, OUTAGE_PODS, OUTAGE_PODS)
    o_cpu = workloads.run_fabric_outage(small, "cpu", percentage=100)
    o_gpu = workloads.run_fabric_outage(small, "cuda")
    for label, run in (("cpu", o_cpu), ("cuda", o_gpu)):
        _check_outage(f"{small.name} [all replicas down, {label}]", run, 2 * OUTAGE_PODS,
                      card=label == "cuda")
    if o_gpu["placed"] != o_cpu["placed"]:
        raise AssertionError(f"{small.name} [all replicas down]: placements differ from the "
                             "cpu's")
    print(f"{small.name} with every replica down: the breaker opened, "
          f"{o_gpu['outage']['degraded_pods']} pods on the sequential path, nothing dispatched "
          f"while open; after the heal the batched path on replica {o_gpu['healed']['active']} "
          f"({o_gpu['healed']['batches'][1]} batches, {o_gpu['healed']['launches']} fused "
          "launches); placements == the cpu's")
    out[f"{small.name}/outage"] = {"launches": o_gpu["healed"]["launches"], "run": o_gpu}
    part("outage")

    have_grpc = (importlib.util.find_spec("grpc") is not None
                 and importlib.util.find_spec("google.protobuf") is not None)
    if not have_grpc:
        print("gRPC: not run, grpc or google.protobuf is not installed on this machine; the "
              "gRPC transport runs in the CPU tests only")
    else:
        import google.protobuf
        import grpc

        print(f"gRPC: run, grpc {grpc.__version__}, protobuf {google.protobuf.__version__}")
        big = workloads.scheduling_basic(N_NODES, N_PODS, N_PODS)
        with _env(**RING):
            l_cpu = workloads.run_loop(big, "cpu", percentage=100)
        both = {}
        for transport in ("grpc", "http"):
            label = f"{big.name} [{transport}, depth 0]"
            gpu = _wire_run(big, label, "cuda", 0, transport=transport)
            _check_wire_same(label, gpu, l_cpu, WIRE_LOOP_KEYS, "cpu loop")
            _check_all_bound(label, big, gpu)
            if set(gpu["paths"]) != {"fused"} or not (
                    gpu["launches"] == gpu["batches"] == gpu["client_batches"]):
                raise AssertionError(f"{label}: paths {set(gpu['paths'])}, {gpu['launches']} "
                                     f"launches, {gpu['batches']} batches run, "
                                     f"{gpu['client_batches']} sent")
            both[transport] = gpu
        g, h = both["grpc"], both["http"]
        print(f"{big.name} over gRPC: placements, counters and queue == the cpu loop, one fused "
              f"launch per batch; per measured batch (median ms) gRPC / HTTP: "
              + ", ".join(f"{k} {g['wire_split_ms'][k]:.3f} / {h['wire_split_ms'][k]:.3f}"
                          for k in g["wire_split_ms"] if g["wire_split_ms"][k] is not None)
              + f"; scheduleBatch request bytes gRPC {g['request_bytes']} (template "
              f"deduplicated) / HTTP JSON {h['request_bytes']} over {g['client_batches']} "
              f"batches; pods/s {g['pods_per_s']:.1f} / {h['pods_per_s']:.1f}")
        out[f"{big.name}/grpc"] = {"launches": g["launches"], "run": g}
        part("grpc")
    print("loop_fabric phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; total {sum(parts.values()):.1f}")
    return out


# ---------------------------------------------------------------- shard phase

# timed batches after the first per sharded run on the card at W <= 2 and
# the stretch; the W=4 runs time their one batch (each collective is a gloo
# round trip of 1.5-3.0 ms on the card's host, PERF.md §6 PR 21)
SHARD_REPEAT = 1
SHARD_TIMEOUT_S = 300.0
STRETCH_NODES, STRETCH_SLOTS, STRETCH_PODS, STRETCH_WORLD = 50000, 65536, 64, 8


def _on(x, device):
    return type(x).from_numpy(x.to_numpy(), device)


def _single(inputs, device, spec: bool) -> dict:
    """The unsharded program on ``device`` (mode off without ``spec``: the
    fused kernel), as numpy."""
    nt, pb, et, tc, tb, kw = inputs
    res = batch.schedule_batch_core(_on(pb, device), _on(et, device), _on(nt, device),
                                    batch.DEFAULT_WEIGHTS, _on(tc, device), _on(tb, device),
                                    kw["topo_mode"], kw["vd_override"], kw["host_key"],
                                    spec_decode=spec)
    torch.cuda.synchronize()
    return launch.result_to_numpy(res)


def _sharded(label: str, world: int, device, runs, repeat: int = SHARD_REPEAT) -> dict:
    """``runs`` (name -> (inputs, spec)) through ``schedule_cases`` at
    ``world`` ranks on ``device``, each batch run once and, on the card,
    ``repeat`` more times; prints each run's numbers on the card. Fails
    when a rank launched the fused kernel (the sharded program takes the
    scan or the rounds). Returns name -> rank 0's record, with ``peaks``
    (every rank's)."""
    names = list(runs)
    repeat = repeat if device == "cuda" else 0
    cases = []
    for name in names:
        (nt, pb, et, tc, tb, kw), spec = runs[name]
        cases.append(launch.case_fields(pb, et, nt, tc, tb, spec_decode=spec, repeat=repeat,
                                        **kw))
    t0 = time.perf_counter()
    ranks = launch.run_ranks(launch.schedule_cases, world, device=device, args=(cases,),
                             timeout_s=SHARD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = {}
    for i, name in enumerate(names):
        rec = dict(ranks[0][i], peaks=[r[i]["peak_bytes"] for r in ranks])
        counts = {(r[i]["collectives"], r[i]["collective_bytes"]) for r in ranks}
        if len(counts) != 1:
            raise AssertionError(f"{label} {name}: the ranks issued different collectives "
                                 f"{sorted(counts)}")
        launches = [r[i]["fused_launches"] for r in ranks]
        if any(launches):
            raise AssertionError(f"{label} {name}: fused launches per rank {launches}, not 0")
        out[name] = rec
        if device == "cuda":
            timed = rec["ms"][1:] or rec["ms"]
            backend = launch.default_backend(torch.device(device), world)
            print(f"{label} {name} at W={world} ({backend} on the card): "
                  f"{statistics.median(timed):.3f} ms per batch ("
                  + (f"median of {len(timed)} after the first, {rec['ms'][0]:.3f}" if repeat
                     else "its one batch")
                  + f"), {rec['collectives']} collectives "
                  f"of {rec['collective_bytes']} bytes per batch, 0 fused launches on "
                  f"every rank; allocator peak per rank (MiB) "
                  + ", ".join("n/a" if p is None else f"{p / 2**20:.1f}" for p in rec["peaks"]))
    if device == "cuda":
        print(f"{label} at W={world}: {len(names)} runs in one spawn, {wall:.1f} s wall with "
              "process start")
    return out


def _same(label: str, got: dict, want: dict, what: str) -> None:
    bad = launch.result_diff(got, want)
    if bad:
        raise AssertionError(f"{label}: differs from {what} in {bad}")


def _parts():
    """(parts, part): ``part(name)`` books the seconds since the last call."""
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        parts[name] = time.perf_counter() - t_part[0]
        t_part[0] = time.perf_counter()

    return parts, part


def _card_note(phase: str, parts: dict) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(f"{phase} phase: every rank of every world size shared one card ({card}); no "
          "multi-card run exists, so these times measure no scaling")
    print(f"{phase} phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"; total {sum(parts.values()):.1f}")


def shard_phase() -> dict:
    """Node-axis sharding on the card at W=1, 2 and 4: ranks as processes
    sharing the one card (``kubernetes_tpu_torch/parallel/``)."""
    parts, part = _parts()
    name = f"SchedulingBasic/{N_NODES}Nodes"
    basic = sharding.batch_inputs(workloads.scheduling_basic_nodes(N_NODES),
                          workloads.scheduling_basic_pods("init", P))
    if basic[5]["topo_mode"] != "off":
        raise AssertionError(f"{name}: mode {basic[5]['topo_mode']}, not off")
    before = fused_step.LAUNCHES
    fused = _single(basic, "cuda", spec=False)
    launches = fused_step.LAUNCHES - before
    if launches != 1:
        raise AssertionError(f"{name}: {launches} fused launches for one unsharded batch")
    runs = {"scan": (basic, False), "rounds": (basic, True)}
    w1 = _sharded(name, 1, "cuda", runs)
    for run, rec in w1.items():
        _same(f"{name} {run} W=1 (nccl)", rec["result"], fused,
              "the unsharded fused-kernel batch")
    print(f"{name}: the W=1 NCCL scan and rounds == the unsharded fused-kernel batch bit for "
          f"bit ({int((fused['node_idx'] >= 0).sum())}/{P} placed; {launches} fused launch)")
    part("basic W=1")
    # the fused kernel's launches: the unsharded reference batch's, and
    # every sharded run's on every rank (0, asserted in ``_sharded``)
    out = {name: {"launches": launches},
           **{f"{name} {run} W=1": {"launches": 0} for run in runs}}
    gpu, cpu = _sharded(name, 2, "cuda", runs), _sharded(name, 2, "cpu", runs)
    for run in runs:
        _same(f"{name} {run} W=2", gpu[run]["result"], cpu[run]["result"],
              "the CPU's W=2 gloo run")
        _same(f"{name} {run} W=2", gpu[run]["result"], fused, "the unsharded fused-kernel batch")
        out[f"{name} {run} W=2"] = {"launches": 0}
    print(f"{name} at W=2 on the card == the CPU's W=2 run == the unsharded batch, scan and "
          "rounds")
    part("basic W=2")

    spread = workloads.topology_spreading()
    anti = workloads.scheduling_pod_anti_affinity()
    topo = {"spread": sharding.batch_inputs(sharding.bind_init(spread, spread.init_pods),
                                    spread.measured_pod_list()[:P]),
            "anti": sharding.batch_inputs(sharding.bind_init(anti, anti.init_pods),
                                  anti.measured_pod_list()[:P])}
    for key, mode in (("spread", "general"), ("anti", "host")):
        if topo[key][5]["topo_mode"] != mode:
            raise AssertionError(f"{key}: mode {topo[key][5]['topo_mode']}, not {mode}")
    runs4 = dict(runs, **{"spread scan": (topo["spread"], False),
                          "spread rounds": (topo["spread"], True),
                          "anti rounds": (topo["anti"], True)})
    part("topology inputs")
    gpu, cpu = _sharded("W=4", 4, "cuda", runs4, 0), _sharded("W=4", 4, "cpu", runs4)
    for run, (inputs, spec) in runs4.items():
        label = f"{run} W=4"
        _same(label, gpu[run]["result"], cpu[run]["result"], "the CPU's W=4 gloo run")
        want = fused if inputs is basic else _single(inputs, "cuda", spec)
        _same(label, gpu[run]["result"], want, "the single-device run on the card")
        out[label if inputs is not basic else f"{name} {label}"] = {"launches": 0}
    for key, w, paths in (("spread", spread, "scan and rounds"), ("anti", anti, "rounds")):
        placed = int((gpu[f"{key} rounds"]["result"]["node_idx"] >= 0).sum())
        print(f"{w.name} ({topo[key][5]['topo_mode']}), one measured batch after "
              f"{w.init_pods} init pods bound: the W=4 {paths} on the card == the "
              f"single-device card run == the CPU's W=4 run ({placed}/{P} placed)")
    print(f"{name} at W=4 on the card == the CPU's W=4 run == the unsharded batch")
    part("W=4")
    _card_note("shard", parts)
    return out


def shard_scale_phase() -> dict:
    """The stretch shape at W=8 and ``entry.dryrun_multichip(4)``, the ranks
    sharing the one card (in the loop group, beside the shard phase's)."""
    from kubernetes_tpu_torch.backend.device_state import caps_for_cluster

    parts, part = _parts()
    infos = [NodeInfo(make_node(f"n{i}").capacity(
        {"cpu": "8", "memory": "16Gi", "pods": 32}).obj()) for i in range(STRETCH_NODES)]
    caps = dataclasses.replace(caps_for_cluster(STRETCH_SLOTS), nodes=STRETCH_SLOTS,
                               pods=STRETCH_PODS)
    pods = [make_pod(f"p{i}").req({"cpu": "2", "memory": "2Gi"}).obj()
            for i in range(STRETCH_PODS)]
    stretch = sharding.batch_inputs(infos, pods, caps)
    part("stretch inputs")
    label = f"Stretch/{STRETCH_NODES}Nodes in {STRETCH_SLOTS} slots"
    st = _sharded(label, STRETCH_WORLD, "cuda",
                  {"scan": (stretch, False), "rounds": (stretch, True)})
    idx = st["scan"]["result"]["node_idx"]
    if not np.array_equal(idx, st["rounds"]["result"]["node_idx"]):
        raise AssertionError(f"{label}: the rounds differ from the scan")
    if not ((idx >= 0).all() and (idx < STRETCH_NODES).all()
            and len(set(idx.tolist())) == STRETCH_PODS):
        raise AssertionError(f"{label}: a winner invalid or shared: {idx.tolist()}")
    out = {f"{label} {run} W={STRETCH_WORLD}": {"launches": 0} for run in st}
    print(f"{label} at W={STRETCH_WORLD}: scan == rounds, {STRETCH_PODS} distinct valid winners "
          f"on ranks {sorted({int(i) // (STRETCH_SLOTS // STRETCH_WORLD) for i in idx})}")
    part("stretch")

    dry = port_entry.dryrun_multichip(4)
    print("entry.dryrun_multichip(4) on the card: the four programs' checks pass; "
          + ", ".join(f"{run} {rec['collectives']} collectives {rec['ms'][0]:.1f} ms"
                      for run, rec in zip((r[0] for r in port_entry.DRYRUN_RUNS),
                                          dry["ranks"][0])))
    if any(rec["fused_launches"] for rank in dry["ranks"] for rec in rank):
        raise AssertionError("entry.dryrun_multichip(4): a rank launched the fused kernel")
    out.update({f"dryrun {run[0]} W=4": {"launches": 0} for run in port_entry.DRYRUN_RUNS})
    part("dryrun")
    _card_note("shard_scale", parts)
    return out


def bs_other(prev: dict) -> str:
    return sorted(set(prev["gpu"]["paths"]))[-1]


# ---------------------------------------------------------------- groups
#
# The phases run in three processes at once on the one card, each phase in
# the group of the phases whose results it reads. The card is idle most of
# the time (the loop's host work bounds it), so the groups share it and the
# host's cores; their timings are taken beside each other (the kernel
# phase, whose numbers enter the kernels line, runs alone before them).


def core_group(timed, kern: dict) -> dict:
    sl = timed("slice", slice_phase)
    topo = timed("topology", topology_phase)
    spec = timed("spec", spec_phase, sl, topo)
    loop = timed("loop", loop_phase, topo, spec)
    fabric = timed("loop_fabric", loop_fabric_phase)
    return {"main_launches": sl["launches"],
            "launches": {sl["workload"].name: sl["launches"],
                         **{f"loop:{k}": v["launches"] for k, v in loop.items()},
                         **{f"fabric:{k}": v["launches"] for k, v in fabric.items()}}}


def batch_group(timed, kern: dict) -> dict:
    dra = timed("dra", dra_phase)
    gangs = timed("gang", gang_phase)
    quota = timed("quota", quota_phase)
    pre_all = timed("preempt_all", preempt_all_phase)
    loop_gang = timed("loop_gang", loop_gang_phase, gangs, quota)
    loop_claims = timed("loop_claims", loop_claims_phase, dra)
    shard = timed("shard", shard_phase)
    slices = next(v for v in gangs.values() if v["workload"].tpu_slots)
    return {"slice_masked_ms": slices["masked_ms"], "slice_unmasked_ms": slices["plain_ms"],
            "launches": {**{k: v["launches"] for k, v in dra.items()},
                         **{k: v["launches"] for k, v in gangs.items()},
                         **{k: v["launches"] for k, v in quota.items()},
                         **{k: v["launches"] for k, v in pre_all.items()},
                         **{f"loop:{k}": v["launches"] for k, v in loop_gang.items()},
                         **{f"loop:{k}": v["launches"] for k, v in loop_claims.items()},
                         **{f"shard:{k}": v["launches"] for k, v in shard.items()}}}


def loop_group(timed, kern: dict) -> dict:
    loop = timed("loop_basic", loop_basic_phase)
    loop_faults = timed("loop_faults", loop_faults_phase, loop)
    loop_profiles = timed("loop_profiles", loop_profiles_phase, loop)
    loop_admission = timed("loop_admission", loop_admission_phase, loop)
    loop_telemetry = timed("loop_telemetry", loop_telemetry_phase, loop, kern)
    loop_rebalance = timed("loop_rebalance", loop_rebalance_phase)
    loop_wire = timed("loop_wire", loop_wire_phase, loop)
    pre = timed("preempt", preempt_phase)  # here for the groups' balance
    shard_scale = timed("shard_scale", shard_scale_phase)  # likewise
    entropy = loop_rebalance.pop("packing_entropy")
    loop.pop(CPU_BASIC)
    loop.pop(CPU_PREEMPT)
    warm_launches = loop_faults.pop("warm_launches")
    print("packing_entropy (an XLA program of the JAX package, plain PyTorch in the port): "
          + "; ".join(f"{k}: {v['ms']:.4f} ms on the card, {v['kernels']} kernel launches "
                      f"per call, "
                      f"plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.6f} ms, "
                      f"|err| {v['max_abs_err']:.3g}" for k, v in entropy.items()))
    return {"warm_launches": warm_launches,
            "launches": {**{f"loop:{k}": v["launches"]
                            for part in (loop, loop_faults, loop_profiles, loop_admission,
                                         loop_telemetry, loop_rebalance)
                            for k, v in part.items()},
                         **{f"wire:{k}": v["launches"] for k, v in loop_wire.items()},
                         **{k: v["launches"] for k, v in pre.items()},
                         **{f"shard:{k}": v["launches"] for k, v in shard_scale.items()}}}


GROUPS = {"core": core_group, "batch": batch_group, "loop": loop_group}
GROUPS_DEADLINE_S = 1080  # the groups are stopped past this, with the script's failure


def group_main(name: str, kern_path: str, out_path: str) -> int:
    """One group's phases in this process; its results go to ``out_path``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // len(GROUPS)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(kern_path) as f:
        kern = json.load(f)
    phase_s = {}

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[phase] = time.perf_counter() - t
        return out

    res = GROUPS[name](timed, kern)
    with open(out_path, "w") as f:
        json.dump({**res, "phase_s": phase_s}, f)
    return 0


def run_groups(kern: dict) -> dict | None:
    """Starts every group at once, waits for all, and replays their output
    in order (a failed group's last). On a failure or past the deadline the
    other groups are stopped and None is returned."""
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        kern_path = os.path.join(tmp, "kernel.json")
        with open(kern_path, "w") as f:
            json.dump(kern, f)
        procs, logs, failed = {}, {}, []
        try:
            for name in GROUPS:
                logs[name] = (open(os.path.join(tmp, f"{name}.out"), "w+"),
                              open(os.path.join(tmp, f"{name}.err"), "w+"))
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--group", name, kern_path,
                     os.path.join(tmp, f"{name}.json")],
                    stdout=logs[name][0], stderr=logs[name][1])
            pending = set(GROUPS)
            while pending and not failed:
                time.sleep(0.5)
                for name in sorted(pending):
                    if procs[name].poll() is not None:
                        pending.discard(name)
                        if procs[name].returncode:
                            failed.append(f"{name} (exit {procs[name].returncode})")
                if pending and time.monotonic() - t0 > GROUPS_DEADLINE_S:
                    failed.extend(f"{name} (past {GROUPS_DEADLINE_S} s)" for name in pending)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        order = sorted(GROUPS, key=lambda name: any(f.startswith(name) for f in failed))
        for name in order:
            for log, stream in zip(logs[name], (sys.stdout, sys.stderr)):
                log.seek(0)
                stream.write(log.read())
                log.close()
            sys.stdout.flush()
            sys.stderr.flush()
        print(f"groups ran at once in {time.monotonic() - t0:.1f} s wall")
        if failed:
            print("chip_smoke: group failed: " + ", ".join(failed), file=sys.stderr)
            return None
        out = {}
        for name in GROUPS:
            with open(os.path.join(tmp, f"{name}.json")) as f:
                out[name] = json.load(f)
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    lib = fused_step.build_library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    report = lib.with_suffix(".ptxas.txt")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())
    t = time.perf_counter()
    kern = kernel_phase(torch.device("cuda"))
    phase_s = {"kernel": time.perf_counter() - t}
    groups = run_groups(kern)
    if groups is None:
        return 1
    core, bat, lp = groups["core"], groups["batch"], groups["loop"]
    for g in groups.values():
        phase_s.update(g["phase_s"])
    print("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(f"whole script {time.perf_counter() - t0:.1f} s wall")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    print(json.dumps({"kernels": [{
        "name": "fused_step_batch", "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/fused_step.cu",
        "replaces": "kubernetes_tpu/ops/pallas_step.py:62",
        "launches": core["main_launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "masked_ms": kern["masked_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None,
        "launches_by_workload": {**core["launches"], **bat["launches"], **lp["launches"]},
        "warm_launches": lp["warm_launches"],
        "slice_masked_ms": bat["slice_masked_ms"],
        "slice_unmasked_ms": bat["slice_unmasked_ms"],
        "status": "ported, exact against the plain version; cluster of 8 blocks"}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--group"]:
        sys.exit(group_main(*sys.argv[2:5]))
    sys.exit(main())
