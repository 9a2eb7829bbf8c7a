"""Scheduler command (cmd/kube-scheduler/app/server.go): an own copy of
``kubernetes_tpu/cmd/server.py``.

``setup`` decodes KubeSchedulerConfiguration (v1beta2/v1beta3 YAML),
builds the scheduler over a store, and ``SchedulerApp`` wires the
component-base serving surface: /healthz, /readyz, /configz, /metrics and
the /debug family on one mux (server.go:146 Run installs the same
endpoints), plus leader election (server.go:205-225) gating the scheduling
loop.

The port's scheduler is always its ``TPUScheduler`` on ``device`` (None
means the card, and raises without one), or the ``WireScheduler`` client of
device services. The JAX package builds its sequential ``Scheduler`` when
``tpu`` is off (or the TPUBatchedScheduling gate is); here that is the same
loop driven through ``schedule_one`` alone (``SchedulerApp.tick``), as the
perf harness's ``oracle`` backend drives it. The /debug device handlers
read the host mirror of the device rows (``DeviceState._mirror``), never a
device tensor, from the serving thread.

``main()`` is the binary: ``python -m kubernetes_tpu_torch.cmd.server
--config f.yaml [--simulate nodes=N,pods=P] [--device cpu]``; simulate mode
stands in for a cluster the way kubemark hollow nodes do. The loop runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..apiserver.store import Store
from ..client.informer import SharedInformerFactory
from ..client.leaderelection import LeaderElectionConfig, LeaderElector
from ..config.factory import scheduler_from_config
from ..config.types import KubeSchedulerConfiguration, load_config
from ..metrics.registry import Registry
from ..scheduler.scheduler import settle_sequential
from ..utils.device import DeviceLike, resolve_device
from ..utils.featuregate import DEFAULT_FEATURE_GATE


# default per-list entry cap for /debug dumps (override per request with
# ?limit=N): a 5k-node queue/cache dump serialized whole is megabytes of
# JSON from the serving thread — bounded by default, explicit to go deeper
DEFAULT_DEBUG_LIMIT = 1000


def _cap(items, limit):
    """(first ``limit`` entries, original length if truncated else None) —
    the one cap-plus-marker primitive every /debug handler shares, so a
    capped list is never indistinguishable from a genuinely short one."""
    items = list(items)
    if limit is not None and 0 <= limit < len(items):
        return items[:limit], len(items)
    return items, None


def _accepts_limit(fn) -> bool:
    """Whether a debug handler takes the ``limit`` kwarg (checked by
    signature, never by catching TypeError around the CALL — a genuine
    TypeError from inside the handler must not re-execute it uncapped)."""
    import inspect

    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return ("limit" in params
            or any(p.kind == p.VAR_KEYWORD for p in params.values()))


class ComponentServer:
    """healthz/readyz/configz/metrics/debug mux shared by the component
    binaries (component-base: healthz.InstallHandler + configz +
    legacyregistry + the /debug introspection family)."""

    def __init__(self, configz: dict, registry: Optional[Registry] = None,
                 ready_fn=None, port: int = 0, debug: Optional[dict] = None):
        self.configz = configz
        self.registry = registry
        self.ready_fn = ready_fn or (lambda: True)
        # /debug/<name> → zero-arg callable returning a JSON-serializable
        # body (build_debug_handlers wires the scheduler's set)
        self.debug = debug or {}
        # signature introspection is constant per handler — once here, not
        # per request on the serving thread
        self._debug_accepts_limit = {n: _accepts_limit(f)
                                     for n, f in self.debug.items()}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    self._respond(200, "ok", "text/plain")
                elif path == "/readyz":
                    ok = outer.ready_fn()
                    self._respond(200 if ok else 500, "ok" if ok else "not ready", "text/plain")
                elif path == "/configz":
                    self._respond(200, json.dumps(outer.configz), "application/json")
                elif path == "/metrics":
                    # the 0.0.4 text exposition; the port's registry keeps no
                    # exemplars, so an OpenMetrics scraper gets it too
                    text = outer.registry.expose() if outer.registry else ""
                    self._respond(200, text, "text/plain; version=0.0.4")
                elif path == "/debug" or path == "/debug/":
                    self._respond(200, json.dumps(
                        {"endpoints": sorted("/debug/" + n for n in outer.debug)}),
                        "application/json")
                elif path.startswith("/debug/"):
                    name = path[len("/debug/"):]
                    fn = outer.debug.get(name)
                    if fn is None:
                        self._respond(404, "not found", "text/plain")
                        return
                    # ?limit=N caps unbounded dumps (queue/cache/spans/...)
                    # at N entries per list; the default keeps a 5k-node
                    # dump bounded instead of serializing the whole world
                    import urllib.parse as _up

                    limit = DEFAULT_DEBUG_LIMIT
                    try:
                        q = _up.parse_qs(query)
                        if "limit" in q:
                            limit = max(0, int(q["limit"][0]))
                    except (ValueError, IndexError):
                        pass
                    try:
                        out = (fn(limit=limit)
                               if outer._debug_accepts_limit.get(name)
                               else fn())
                        body = json.dumps(out, default=str)
                    except Exception as exc:  # noqa: BLE001 — debug must not kill serving
                        self._respond(500, json.dumps(
                            {"error": f"{type(exc).__name__}: {exc}"}),
                            "application/json")
                        return
                    self._respond(200, body, "application/json")
                else:
                    self._respond(404, "not found", "text/plain")

            def _respond(self, code, body, ctype):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _device_occupancy(device) -> dict:
    """Per-axis tensor occupancy for /debug/devicestate: used vs capacity
    per RESOURCE axis (summed over valid mirrored rows — the question an
    operator actually asks: how full is the fleet per resource?) plus how
    much of each static vocab/axis the encoder has consumed. ``device`` is
    the loop's ``DeviceState``; only its host mirror is read, never a device
    tensor, from the serving thread."""
    from ..ops import schema

    mirror = device._mirror
    valid = mirror["valid"].reshape(-1).astype(bool)
    used = mirror["requested"][valid].sum(axis=0)
    cap = mirror["allocatable"][valid].sum(axis=0)
    enc = device.encoder
    fixed = (("cpu", schema.COL_CPU), ("memory", schema.COL_MEM),
             ("ephemeral-storage", schema.COL_EPH), ("pods", schema.COL_PODS))
    resources = {name: {"used": int(used[col]), "capacity": int(cap[col])}
                 for name, col in fixed}
    for rid in range(1, len(enc.scalar_vocab)):
        col = schema.N_FIXED_COLS + rid - 1
        if col < used.shape[0]:
            resources[str(enc.scalar_vocab.item(rid))] = {
                "used": int(used[col]), "capacity": int(cap[col])}
    caps = device.caps
    axes = {
        "nodes": {"used": int(valid.sum()), "capacity": caps.nodes},
        "resources": {"used": schema.N_FIXED_COLS + len(enc.scalar_vocab) - 1,
                      "capacity": caps.resources},
        "labelKeys": {"used": len(enc.key_vocab) - 1,
                      "capacity": caps.label_keys},
        "ports": {"used": len(enc.port_vocab) - 1,
                  "capacity": caps.port_words * 32},
        # live(), not len-1: image ids free when the last reporting node
        # leaves (elastic churn), so the raw table length counts holes
        "images": {"used": enc.image_vocab.live(), "capacity": caps.images},
        "prioClasses": {"used": len(enc.prio_vocab),
                        "capacity": caps.prio_classes},
        "sigs": {"used": device.sig_table.n_sigs, "capacity": caps.sigs},
        "attrKeys": {"used": len(device.attr_slots),
                     "capacity": device._attr_cols},
    }
    return {"resources": resources, "axes": axes}


def _slice_rows(device):
    """(fragmentation rows, per-cell free map, grid) off the host mirror —
    the shared read for /debug/slices and the devicestate topology block.
    No device round-trip: slice-free means zero pods on the host."""
    from ..ops.schema import COL_PODS
    from ..ops.slice import fragmentation_host

    mirror = device._mirror
    valid = mirror["valid"].reshape(-1).astype(bool)
    sp_arr = mirror["topo_sp"].reshape(-1)
    pos_arr = mirror["topo_pos"].reshape(-1)
    free = valid & (mirror["requested"][:, COL_PODS] == 0)
    grid = (device.caps.superpods, device.caps.sp_slots)
    rows = fragmentation_host(sp_arr, pos_arr, valid, free, grid)
    cell_free = {}
    for idx in range(len(sp_arr)):
        sp, pos = int(sp_arr[idx]), int(pos_arr[idx])
        if valid[idx] and 0 <= sp < grid[0] and 0 <= pos < grid[1]:
            cell_free[(sp, pos)] = bool(free[idx])
    return rows, cell_free, grid


def _topology_block(device, limit=None) -> dict:
    """Per-node torus coords + per-superpod free/used chip counts for
    /debug/devicestate (``?limit=`` caps the node list)."""
    from ..ops import schema

    mirror = device._mirror
    nodes = []
    for name, slot in sorted(device.encoder.node_slots.items()):
        sp = int(mirror["topo_sp"][slot])
        pos = int(mirror["topo_pos"][slot])
        if sp >= 0 and pos >= 0:
            nodes.append({"node": name, "superpod": sp, "slot": pos})
    capped, orig = _cap(nodes, limit)
    rows, _cells, grid = _slice_rows(device)
    out = {
        "chipsPerNode": schema.CHIPS_PER_NODE,
        "grid": {"superpods": grid[0], "slots": grid[1]},
        "nodes": capped,
        "superpods": [{"sp": r["sp"],
                       "freeChips": r["free"] * schema.CHIPS_PER_NODE,
                       "usedChips": r["used"] * schema.CHIPS_PER_NODE}
                      for r in rows],
    }
    if orig is not None:
        out["nodesTruncated"] = orig
    return out


def build_debug_handlers(sched) -> dict:
    """The /debug endpoint family over a live scheduler (SURVEY §5.2's
    SIGUSR2 comparer/dumper, but always-on and JSON over the serving mux):

      /debug/queue        active/backoff/unschedulable dump
      /debug/cache        comparer drift report + node/pod/assumed counts
      /debug/devicestate  DeviceState capacities, sig-table occupancy,
                          batch-sizer model, torus topology block
                          (TPU/batched schedulers only)
      /debug/slices       torus occupancy map: per-superpod cell strings
                          plus free/used/largest-run/fragmentation rows
                          (the slice-packing operator view)
      /debug/spans        tail of the in-memory span exporter
      /debug/circuit      device-service circuit breaker state, resync and
                          degradation counters (WireScheduler only)
      /debug/fabric       device-side HA fabric: active replica, per-
                          endpoint health/breaker/epoch, failover journal
                          (WireScheduler with >1 device endpoint)
      /debug/sessions     HA session table: this replica's identity plus the
                          device service's per-client lease age, deltaSeq,
                          and in-flight hold counts (WireScheduler only)
      /debug/flightrecorder  device-runtime flight recorder: compile/retrace
                          ledger, HBM/transfer counters, and the bounded
                          event ring (backend/telemetry.py; enabled=False
                          when the telemetry layer is off)
      /debug/dispatch     dispatch profiler: per-(program, bucket) device-
                          time stats with cost-ledger flops/bytes (achieved
                          FLOP/s where both exist) and the per-dispatch
                          dwell/exec/fetch record ring (backend/telemetry.py
                          DispatchLedger; enabled=False when telemetry off)
      /debug/locktrace    lock-order graph, acquisition counts, blocking
                          events from testing/locktrace.py (enabled only
                          under KTPU_LOCKTRACE=1)
      /debug/quota        per-namespace SchedulingQuota caps, the ledger's
                          live usage, fair-share weight, charged pod count,
                          plus the per-cohort borrowing pool: guaranteed/
                          lent/headroom, outstanding loans (newest first),
                          pending reclaim demand, reclaim breaker state
      /debug/ledger       pod-lifetime latency ledger: live/closed entry
                          counts, eviction count, per-pod segment
                          accumulators (metrics/latency_ledger.py;
                          enabled=False when the ledger is off)
      /debug/timeline     unified Chrome trace-event JSON (Perfetto /
                          chrome://tracing loadable): span tail + flight-
                          recorder events + ledger pod segments + the
                          dispatch profiler's device track on one
                          wall-clock axis, batchId/pod-UID correlated
      /debug/rebalance    continuous-rebalancing state: trigger band +
                          current packing score, wave budget, SLO breaker,
                          recent migration waves, pending uncordons
                          (enabled=False without an attached Rebalancer)

    Every handler takes an entry cap (``?limit=N`` on the mux, default
    DEFAULT_DEBUG_LIMIT) so a 5k-node dump stays bounded.
    """
    from ..cache.debugger import CacheComparer
    from ..utils import tracing

    def _capped_lists(out, limit, keys):
        """Cap ``out[key]`` lists in place, recording original lengths
        under out["truncated"][key] (counts stay exact, truncation is
        always visible)."""
        for key in keys:
            entries, orig = _cap(out.get(key) or [], limit)
            out[key] = entries
            if orig is not None:
                out.setdefault("truncated", {})[key] = orig
        return out

    def queue_dump(limit=None):
        return _capped_lists(sched.queue.dump(), limit,
                             ("active", "backoff", "unschedulable", "gated"))

    def quota_dump(limit=None):
        plugin = sched._quota_plugin()
        if plugin is None:
            return {"enabled": False}
        out = plugin.dump()
        # cohort pool view rides the same dump under a reserved key so the
        # per-namespace table stays flat
        cohorts = out.pop("_cohorts", {})
        capped, orig = _cap(sorted(out.items()), limit)
        result = {"enabled": True, "namespaces": dict(capped)}
        if orig is not None:
            result["namespacesTruncated"] = orig
        ccapped, corig = _cap(sorted(cohorts.items()), limit)
        result["cohorts"] = {}
        for name, entry in ccapped:
            loans, lorig = _cap(entry.get("loans") or [], limit)
            entry = dict(entry, loans=loans)
            if lorig is not None:
                entry["loansTruncated"] = lorig
            result["cohorts"][name] = entry
        if corig is not None:
            result["cohortsTruncated"] = corig
        return result

    def cache_dump(limit=None):
        comparer = CacheComparer(sched.store, sched.cache, sched.queue)
        missed_n, redundant_n = comparer.compare_nodes()
        missed_p, redundant_p = comparer.compare_pods()
        nodes, pods, assumed = sched.cache.stats()
        return _capped_lists({
            "nodes": nodes, "pods": pods, "assumedPods": assumed,
            "inSync": not (missed_n or redundant_n or missed_p or redundant_p),
            "missedNodes": missed_n, "redundantNodes": redundant_n,
            "missedPods": missed_p, "redundantPods": redundant_p,
        }, limit, ("missedNodes", "redundantNodes", "missedPods",
                   "redundantPods"))

    def device_dump(limit=None):
        import dataclasses

        device = getattr(sched, "state", None)
        if device is None:
            return {"enabled": False}
        occupancy = _device_occupancy(device)
        capped, orig = _cap(occupancy["resources"].items(), limit)
        if orig is not None:
            occupancy["resources"] = dict(capped)
            occupancy["resourcesTruncated"] = orig
        out = {
            "enabled": True,
            "caps": dataclasses.asdict(device.caps),
            "sigTable": {"nSigs": device.sig_table.n_sigs,
                         "nTerms": device.sig_table.n_terms},
            "topoEnabled": bool(device.topo_enabled),
            "nodesMirrored": len(device.encoder.node_slots),
            "batchCounter": getattr(sched, "batch_counter", 0),
            "pipelinedBatches": getattr(sched, "pipelined_batches", 0),
            "fallbackScheduled": getattr(sched, "fallback_scheduled", 0),
            "batchScheduled": getattr(sched, "batch_scheduled", 0),
            "uploadBytes": device.upload_bytes,
            "occupancy": occupancy,
        }
        sizer = getattr(sched, "sizer", None)
        if sizer is not None:
            out["batchSizer"] = {
                "a": sizer._fit.a, "b": sizer._fit.b, "updates": sizer.updates,
                "deadlineS": sizer.deadline_s, "target": sizer.target(),
                "maxBatch": sizer.max_batch,
            }
        out["topology"] = _topology_block(device, limit)
        return out

    def slices_dump(limit=None):
        """Torus occupancy map: one row per mapped superpod — a cell string
        ('.' free host, '#' used host, '-' no host at that slot) plus the
        free/used/largest-run/fragmentation accounting behind the
        scheduler_slice_fragmentation gauge."""
        device = getattr(sched, "state", None)
        if device is None:
            return {"enabled": False}
        rows, cell_free, grid = _slice_rows(device)
        superpods = []
        for r in rows:
            s = r["sp"]
            cells = "".join(
                "-" if (s, b) not in cell_free
                else ("." if cell_free[(s, b)] else "#")
                for b in range(grid[1]))
            superpods.append({**r, "map": cells})
        capped, orig = _cap(superpods, limit)
        out = {"enabled": True,
               "grid": {"superpods": grid[0], "slots": grid[1]},
               "superpods": capped}
        if orig is not None:
            out["superpodsTruncated"] = orig
        return out

    def spans_dump(limit=None):
        return [s.to_otlp() for s in tracing.tail(
            256 if limit is None or limit < 0 else limit)]

    def circuit_dump(limit=None):
        if not hasattr(sched, "debug_circuit"):
            return {"enabled": False}
        return sched.debug_circuit()

    def fabric_dump(limit=None):
        if not hasattr(sched, "debug_fabric"):
            return {"enabled": False}
        out = sched.debug_fabric()
        if not out.get("enabled"):
            return out
        return _capped_lists(out, limit, ("replicas", "log"))

    def sessions_dump(limit=None):
        if not hasattr(sched, "debug_sessions"):
            return {"enabled": False}
        out = sched.debug_sessions()
        svc = out.get("service")
        if isinstance(svc, dict) and isinstance(svc.get("sessions"), list):
            svc["sessions"], orig = _cap(svc["sessions"], limit)
            if orig is not None:
                svc["sessionsTruncated"] = orig
        return out

    def flightrecorder_dump(limit=None):
        from ..backend import telemetry

        t = telemetry.get()
        if t is None:
            return {"enabled": False}
        return t.dump(limit)

    def dispatch_dump(limit=None):
        from ..backend import telemetry

        t = telemetry.get()
        if t is None:
            return {"enabled": False}
        return t.dispatch_ledger.dump(limit)

    def locktrace_dump(limit=None):
        from ..testing import locktrace

        if not locktrace.enabled():
            return {"enabled": False}
        out = locktrace.tracer().report()
        out["enabled"] = True
        out["cycles"] = locktrace.tracer().cycles()
        return _capped_lists(out, limit,
                             ("blockingViolations", "blockingAllowed"))

    def ledger_dump(limit=None):
        from ..metrics import latency_ledger

        led = latency_ledger.get()
        if led is None:
            return {"enabled": False}
        return led.dump(limit)

    def rebalance_dump(limit=None):
        rb = getattr(sched, "rebalancer", None)
        if rb is None:
            return {"enabled": False}
        return rb.debug_dump(limit)

    def timeline_dump(limit=None):
        """One Chrome trace-event JSON body unifying the span tail, the
        flight-recorder ring, and the latency ledger's pod segments —
        `curl :PORT/debug/timeline > t.json` then load in Perfetto."""
        from ..backend import telemetry
        from ..metrics import latency_ledger

        cap = 256 if limit is None or limit < 0 else limit
        t = telemetry.get()
        flight = t.flight.dump(cap) if t is not None else []
        dispatch = (t.dispatch_ledger.dump(cap)["records"]
                    if t is not None else [])
        return latency_ledger.chrome_trace(
            spans=tracing.tail(cap), flight=flight, dispatch=dispatch,
            ledger=latency_ledger.get(), limit=cap)

    return {"queue": queue_dump, "cache": cache_dump,
            "devicestate": device_dump, "slices": slices_dump,
            "spans": spans_dump,
            "circuit": circuit_dump, "sessions": sessions_dump,
            "fabric": fabric_dump,
            "flightrecorder": flightrecorder_dump, "quota": quota_dump,
            "dispatch": dispatch_dump,
            "locktrace": locktrace_dump, "ledger": ledger_dump,
            "timeline": timeline_dump, "rebalance": rebalance_dump}


def setup(store: Store, cfg: Optional[KubeSchedulerConfiguration] = None,
          raw: Optional[dict] = None, feature_gates: str = "",
          use_informers: bool = True, device: DeviceLike = None,
          device_endpoints=None, **kwargs):
    """server.go:300 Setup: config + registries → a runnable scheduler.

    Always names its class (the two packages' ``scheduler_from_config``
    default to different ones), and takes no ``tpu``: the JAX setup's
    choice of its sequential ``Scheduler`` is ``SchedulerApp``'s here. It
    builds the ``WireScheduler`` client when
    ``device_endpoints`` (a list or a comma-separated string; more than one
    builds the device fabric, ``backend/fabric.py``) is given, else the
    ``TPUScheduler`` on ``device``. ``device`` None means the card and
    raises without one, on every path. With ``use_informers`` (the
    binary's topology) pod and node events reach the loop through a
    ``SharedInformerFactory`` that its cycles pump. The recorders the
    environment asks for (``KTPU_TRACE_FILE``, ``KTPU_TELEMETRY``,
    ``KTPU_LEDGER``) are turned on as the JAX setup turns them on (the
    ``TPUScheduler``'s constructor does it for its own loop)."""
    device = resolve_device(device)
    if feature_gates:
        DEFAULT_FEATURE_GATE.set_from_string(feature_gates)
    factory = SharedInformerFactory(store) if use_informers else None
    if device_endpoints:
        from ..backend.service import WireScheduler

        kwargs.setdefault("scheduler_cls", WireScheduler)
        kwargs.setdefault("endpoint", device_endpoints)
    else:
        from ..backend.tpu_scheduler import TPUScheduler

        kwargs.setdefault("scheduler_cls", TPUScheduler)
        kwargs.setdefault("device", device)
    sched = scheduler_from_config(store, cfg=cfg, raw=raw, informer_factory=factory, **kwargs)
    if not hasattr(sched, "enable_observability_from_env"):
        from ..backend import telemetry
        from ..metrics import latency_ledger
        from ..utils import tracing

        tracing.maybe_enable_from_env()
        telemetry.maybe_enable_from_env(sched.smetrics)
        latency_ledger.maybe_enable_from_env(sched.smetrics, tenant_fn=sched._ns_fair_weight)
    return sched


class SchedulerApp:
    """The running binary: serving mux + leader-elected scheduling loop."""

    def __init__(self, store: Store, raw_config: Optional[dict] = None,
                 identity: str = "kube-scheduler-0", port: int = 0,
                 feature_gates: str = "", tpu: bool = False, device: DeviceLike = None,
                 device_endpoints=None, wire_pipeline_depth=None, **sched_kw):
        """``sched_kw`` go to the scheduler's constructor (``now_fn``,
        ``batch_size``, ``batch_deadline_ms``, ...)."""
        self.cfg = load_config(raw_config)
        self.store = store
        extra = ({"wire_pipeline_depth": wire_pipeline_depth}
                 if device_endpoints and wire_pipeline_depth is not None
                 else {})
        self.sched = setup(store, cfg=self.cfg, feature_gates=feature_gates,
                           device=device, device_endpoints=device_endpoints,
                           **extra, **sched_kw)
        # batch cycles with ``tpu`` and the TPUBatchedScheduling gate (read
        # after setup applied the flag, ``:544``), or through a device
        # service; else one pod per cycle, as the JAX sequential Scheduler
        self.batched = bool(device_endpoints) or (
            tpu and DEFAULT_FEATURE_GATE.enabled("TPUBatchedScheduling"))
        self.elector = LeaderElector(
            store,
            LeaderElectionConfig(
                lock_name="kube-scheduler", identity=identity,
                lease_duration=self.cfg.leader_elect_lease_duration,
                renew_deadline=self.cfg.leader_elect_renew_deadline,
                retry_period=self.cfg.leader_elect_retry_period,
            ),
            **({"now_fn": sched_kw["now_fn"]} if "now_fn" in sched_kw else {}),
        ) if self.cfg.leader_elect else None
        self.server = ComponentServer(
            configz={"kubescheduler.config.k8s.io": _configz_view(self.cfg)},
            registry=getattr(self.sched.smetrics, "registry", None),
            ready_fn=lambda: True,
            port=port,
            debug=build_debug_handlers(self.sched),
        )
        self._stop = threading.Event()

    def tick(self) -> int:
        """One leader-gated scheduling round; returns cycles run."""
        if self.elector is not None and not self.elector.run_once():
            return 0
        if self.batched:
            return self.sched.run_until_settled()
        return settle_sequential(self.sched)

    def run(self, tick_interval: float = 0.05) -> threading.Thread:
        self.server.start()

        def _loop():
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(tick_interval)

        t = threading.Thread(target=_loop, name="kube-scheduler", daemon=True)
        t.start()
        self._thread = t
        return t

    def stop(self) -> None:
        """Stop the loop (the round in progress ends first), land the
        scheduler's batches in flight and stop the mux."""
        self._stop.set()
        t = getattr(self, "_thread", None)
        if t is not None:
            t.join()
        close = getattr(self.sched, "close", None)
        if close is not None:
            close()
        self.server.stop()


def _configz_view(cfg: KubeSchedulerConfiguration) -> dict:
    return {
        "apiVersion": cfg.api_version,
        "parallelism": cfg.parallelism,
        "percentageOfNodesToScore": cfg.percentage_of_nodes_to_score,
        "podInitialBackoffSeconds": cfg.pod_initial_backoff_seconds,
        "podMaxBackoffSeconds": cfg.pod_max_backoff_seconds,
        "leaderElection": {"leaderElect": cfg.leader_elect},
        "profiles": [p.scheduler_name for p in cfg.profiles],
    }


def _print_batches(sched) -> None:
    """The simulation's batches by commit path, and the fused kernel's
    launches in this process (``ops/fused_step.LAUNCHES``)."""
    from ..ops import fused_step

    paths = getattr(sched, "batch_paths", [])
    by_path = {p: paths.count(p) for p in sorted(set(paths))}
    print(f"scheduler: {len(paths)} batches {by_path}, "
          f"{fused_step.LAUNCHES} fused-kernel launches", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube-scheduler")
    parser.add_argument("--config", help="KubeSchedulerConfiguration YAML path")
    parser.add_argument("--port", type=int, default=10259)
    parser.add_argument("--feature-gates", default="")
    parser.add_argument("--leader-elect", default=None, choices=["true", "false"])
    parser.add_argument("--simulate", default="",
                        help="nodes=N,pods=P: run against a synthetic cluster")
    parser.add_argument("--device", default=None,
                        help="the loop's device (default: the card; 'cpu' runs the plain "
                             "PyTorch versions on the host)")
    parser.add_argument("--device-endpoints", default="",
                        help="comma-separated device-service endpoints "
                             "(http://host:port); more than one enables "
                             "the device-side HA fabric")
    parser.add_argument("--serve-devices", type=int, default=0,
                        help="serve N in-process DeviceService bindings and "
                             "point the scheduler at all of them — the "
                             "single-binary fabric demo topology")
    parser.add_argument("--wire-pipeline-depth", type=int, default=None,
                        help="wire batches kept in flight on the pipelined "
                             "transport (default: KTPU_WIRE_PIPELINE_DEPTH "
                             "or 3; 0 = strictly request/response)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    raw = None
    if args.config:
        import yaml

        with open(args.config) as f:
            raw = yaml.safe_load(f)
    if args.leader_elect is not None:
        raw = dict(raw or {})
        raw.setdefault("leaderElection", {})["leaderElect"] = args.leader_elect == "true"

    store = Store()
    endpoints = [e.strip() for e in args.device_endpoints.split(",")
                 if e.strip()]
    device_servers = []
    app = None
    try:
        if args.serve_devices:
            from ..backend.service import DeviceService, serve

            for _ in range(args.serve_devices):
                server, dev_port = serve(DeviceService(device=device))
                device_servers.append(server)
                endpoints.append(f"http://127.0.0.1:{dev_port}")
            print(f"device fabric: serving {len(device_servers)} DeviceService "
                  f"bindings: {', '.join(endpoints[-len(device_servers):])}")
        app = SchedulerApp(store, raw_config=raw, port=args.port,
                           feature_gates=args.feature_gates, tpu=True, device=device,
                           device_endpoints=endpoints or None,
                           wire_pipeline_depth=args.wire_pipeline_depth)
        if args.simulate:
            from ..api.wrappers import make_node, make_pod

            params = dict(kv.split("=") for kv in args.simulate.split(","))
            for i in range(int(params.get("nodes", 100))):
                store.create_node(make_node(f"node-{i}").capacity(
                    {"cpu": "8", "memory": "32Gi", "pods": 110}).obj())
            for i in range(int(params.get("pods", 200))):
                store.create_pod(make_pod(f"pod-{i}").req(
                    {"cpu": "100m", "memory": "256Mi"}).obj())
        thread = app.run()
        print(f"kube-scheduler serving on 127.0.0.1:{app.server.port} "
              f"(healthz/readyz/configz/metrics); leaderElect={app.cfg.leader_elect}; "
              f"device={device}", flush=True)
        try:
            while thread.is_alive():
                time.sleep(1)
                if args.simulate:
                    bound = sum(1 for p in store.pods.values() if p.spec.node_name)
                    if bound == len(store.pods):
                        print(f"simulation complete: {bound} pods bound", flush=True)
                        _print_batches(app.sched)
                        break
        except KeyboardInterrupt:
            pass
    finally:
        if app is not None:
            app.stop()
        for server in device_servers:
            from ..backend.service import stop

            stop(server)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
