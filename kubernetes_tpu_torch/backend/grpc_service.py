"""The gRPC binding of the batched device service (``kubernetes_tpu/backend/
grpc_service.py``; SURVEY §5.8 hop 6): the same dict payloads as the HTTP
binding (``backend/service.py``), framed as HTTP/2 and protobuf.

Three pieces, as in JAX:

  * the dict <-> proto codecs. ``ScheduleBatch`` deduplicates pod templates
    (``_batch_to_proto``): each pod's name and uid leave its wire dict, and
    pods whose remainders are equal share one template, so a batch of one
    shape is one template and N name references. Results carry their
    preemption hints, and replies the dispatch profiler's ``deviceTime``.
  * ``serve_grpc``: a ``DeviceService`` behind generic method handlers on
    127.0.0.1 (no stubs are generated). A stale epoch answers
    ``FAILED_PRECONDITION`` with the current epoch in its details, a
    conflict ``ABORTED``.
  * ``GrpcClient``: the ``WireClient`` surface over a channel, with the
    same retry policy, error taxonomy (``UNAVAILABLE``,
    ``DEADLINE_EXCEEDED`` and ``RESOURCE_EXHAUSTED`` are transient, every
    other code permanent), session generation and client-side fault plan.

The schema. ``native/ktpu_device.proto`` is the port's copy of the JAX
package's ``native/ktpu_device.proto``, and ``native/ktpu_device_pb2.py``
its vendored module (``tools/gen_torch_pb2.py``). The serialized
``FileDescriptorProto`` is kept byte-identical to the JAX one, with package
``ktpu.v1`` and method paths ``/ktpu.v1.Device/...``: protobuf's default
descriptor pool accepts a second registration of ``ktpu_device.proto`` only
when its bytes are equal, so both packages' modules load in one process, and
each package's client speaks to the other's server. The vendored module is
used while its ``PROTO_SHA256`` matches the ``.proto`` beside it; a stale
one raises ``PermanentDeviceError`` naming ``tools/gen_torch_pb2.py``,
which regenerates it without ``protoc``.
Because the schema is JAX's, the fields the port's HTTP replies add
(``serviceTime``, a result's ``quota`` and ``slice`` words, the CUDA
events' ``deviceExecMs``) do not cross gRPC, as they do not in JAX.

``grpc`` and ``google.protobuf`` are imported only here, inside the
functions that need them: the rest of the port imports without them.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

from .errors import (ConflictError, PermanentDeviceError, RetryPolicy, StaleEpochError,
                     TransientDeviceError, raise_injected_fault)

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_PKG_ROOT, "native")
_PROTO = os.path.join(_NATIVE, "ktpu_device.proto")
_VENDORED = os.path.join(_NATIVE, "ktpu_device_pb2.py")

_pb2 = None
_pb2_lock = threading.Lock()

SERVICE = "ktpu.v1.Device"


def _proto_sha256() -> str:
    import hashlib

    with open(_PROTO, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _vendored_hash() -> Optional[str]:
    """The ``PROTO_SHA256`` literal read from the vendored module's text,
    before it is imported: a stale module is never imported, so its
    descriptor never reaches the default pool."""
    import re

    try:
        with open(_VENDORED, encoding="utf-8") as f:
            head = f.read(4096)
    except OSError:
        return None
    m = re.search(r'^PROTO_SHA256 = "([0-9a-f]{64})"', head, re.M)
    return m.group(1) if m else None


def pb2():
    """The vendored protobuf message module, while its ``PROTO_SHA256``
    matches the ``.proto`` beside it; a stale or missing one raises
    ``PermanentDeviceError`` naming the generator."""
    global _pb2
    if _pb2 is not None:
        return _pb2
    with _pb2_lock:
        if _pb2 is None:
            if _vendored_hash() != _proto_sha256():
                raise PermanentDeviceError(
                    "the vendored kubernetes_tpu_torch/native/ktpu_device_pb2.py is stale or "
                    "missing; run `python tools/gen_torch_pb2.py`")
            from ..native import ktpu_device_pb2

            _pb2 = ktpu_device_pb2
        return _pb2


# ----------------------------------------------------------- dict <-> proto


def _deltas_to_proto(payload: dict):
    p = pb2()
    req = p.ApplyDeltasRequest(full=bool(payload.get("full")))
    for e in payload.get("nodes", ()):
        req.nodes.append(p.NodeDelta(
            node_json=json.dumps(e["node"]).encode(),
            pod_json=[json.dumps(pw).encode() for pw in e.get("pods", ())],
            gen=int(e.get("gen", 0))))
    req.removed.extend(payload.get("removed", ()))
    for ns, labels in (payload.get("namespaces") or {}).items():
        req.namespaces[ns] = json.dumps(labels).encode()
    req.traceparent = payload.get("traceparent") or ""
    req.expect_epoch = payload.get("expectEpoch") or ""
    req.inflight_batch_ids.extend(payload.get("inflightBatchIds") or ())
    req.replicator = bool(payload.get("replicator"))
    _stamp_session_proto(req, payload)
    return req


def _stamp_session_proto(req, payload: dict) -> None:
    """clientId and sessionGen onto a request (0: not joined yet)."""
    req.client_id = payload.get("clientId") or ""
    req.session_gen = int(payload.get("sessionGen") or 0)


def _session_from_proto(req) -> dict:
    out = {"clientId": req.client_id or None}
    if req.session_gen:
        out["sessionGen"] = int(req.session_gen)
    return out


def _deltas_from_proto(req) -> dict:
    out = {
        "full": req.full,
        "nodes": [{"node": json.loads(e.node_json),
                   "pods": [json.loads(b) for b in e.pod_json],
                   "gen": e.gen} for e in req.nodes],
        "removed": list(req.removed),
        "namespaces": {ns: json.loads(b) for ns, b in req.namespaces.items()},
    }
    if req.traceparent:
        out["traceparent"] = req.traceparent
    if req.expect_epoch:
        out["expectEpoch"] = req.expect_epoch
    if req.inflight_batch_ids:
        out["inflightBatchIds"] = list(req.inflight_batch_ids)
    if req.replicator:
        out["replicator"] = True
    out.update(_session_from_proto(req))
    return out


def _batch_to_proto(payload: dict):
    """The template-deduplicating encode (``:205``): each pod's name and uid
    leave its wire dict; equal remainders share one template."""
    from ..api import dra

    p = pb2()
    req = p.ScheduleBatchRequest()
    table: Dict[bytes, int] = {}
    for pw in payload.get("pods", ()):
        meta = dict(pw.get("meta") or {})
        name = meta.pop("name", "")
        uid = meta.pop("uid", "")
        namespace = meta.get("namespace", "default")
        tmpl = json.dumps(dict(pw, meta=meta), sort_keys=True).encode()
        idx = table.get(tmpl)
        if idx is None:
            idx = len(req.templates)
            table[tmpl] = idx
            req.templates.append(tmpl)
        req.pods.append(p.PodRef(template=idx, name=name, namespace=namespace, uid=uid))
    req.tie_seeds.extend(int(s) for s in payload.get("tieSeeds", ()))
    req.traceparent = payload.get("traceparent") or ""
    req.expect_epoch = payload.get("expectEpoch") or ""
    req.batch_id = payload.get("batchId") or ""
    for c in payload.get("claims") or ():
        pc = req.claims.add()
        pc.pod = int(c.get("pod", 0))
        for key, op, kind, operand in c.get("selectors") or ():
            s = pc.selectors.add()
            s.key = str(key)
            s.op = int(op)
            s.kind = int(kind)
            if int(kind) == dra.KIND_INT:
                s.int_val = int(operand)
            else:
                s.str_val = str(operand)
        pc.allocated_nodes.extend(c.get("allocatedNodes") or ())
    _stamp_session_proto(req, payload)
    return req


def _batch_from_proto(req) -> dict:
    """The inverse of ``_batch_to_proto`` (``:247``)."""
    from ..api import dra

    templates = [json.loads(t) for t in req.templates]
    pods = []
    for ref in req.pods:
        tmpl = templates[ref.template]
        meta = dict(tmpl.get("meta") or {})
        meta["name"] = ref.name
        meta["namespace"] = ref.namespace or meta.get("namespace", "default")
        if ref.uid:
            meta["uid"] = ref.uid
        pods.append(dict(tmpl, meta=meta))
    out = {"pods": pods}
    if req.tie_seeds:
        out["tieSeeds"] = list(req.tie_seeds)
    if req.traceparent:
        out["traceparent"] = req.traceparent
    if req.expect_epoch:
        out["expectEpoch"] = req.expect_epoch
    if req.batch_id:
        out["batchId"] = req.batch_id
    if req.claims:
        out["claims"] = [{
            "pod": pc.pod,
            "selectors": [[s.key, s.op, s.kind,
                           s.int_val if s.kind == dra.KIND_INT else s.str_val]
                          for s in pc.selectors],
            "allocatedNodes": list(pc.allocated_nodes),
        } for pc in req.claims]
    out.update(_session_from_proto(req))
    return out


def _results_to_proto(out: dict):
    """The results with their preemption hints (``:282``)."""
    p = pb2()
    resp = p.ScheduleBatchResponse()
    for r in out.get("results", ()):
        pr = p.PodResult(node_name=r.get("nodeName") or "")
        if r.get("conflict"):
            pr.conflict = True
            pr.error = r.get("error") or ""
            resp.results.append(pr)
            continue
        if not pr.node_name:
            pr.unschedulable_plugins.extend(r.get("unschedulablePlugins") or ())
            pr.statuses_json = json.dumps(r.get("statuses") or {}).encode()
            hint = r.get("preempt")
            if hint:
                if hint.get("candidates") is None:
                    pr.preempt.truncated = True
                else:
                    pr.preempt.candidates.extend(hint["candidates"])
                pr.preempt.best = hint.get("best") or ""
        resp.results.append(pr)
    return resp


def _results_from_proto(resp) -> dict:
    results = []
    for pr in resp.results:
        if pr.conflict:
            results.append({"nodeName": None, "conflict": True, "error": pr.error or ""})
            continue
        if pr.node_name:
            results.append({"nodeName": pr.node_name})
            continue
        r = {"nodeName": None,
             "unschedulablePlugins": list(pr.unschedulable_plugins),
             "statuses": json.loads(pr.statuses_json) if pr.statuses_json else {}}
        if pr.HasField("preempt"):
            r["preempt"] = {
                "candidates": None if pr.preempt.truncated else list(pr.preempt.candidates),
                "best": pr.preempt.best or None,
            }
        results.append(r)
    return {"results": results}


def _device_time_to_proto(resp, out: dict) -> None:
    """The dispatch profiler's echoed deviceTime onto the reply (``:335``);
    nothing when the profiler was off."""
    dt = out.get("deviceTime")
    if not isinstance(dt, dict):
        return
    resp.device_time.dwell_ms = float(dt.get("dwellMs") or 0.0)
    resp.device_time.exec_ms = float(dt.get("execMs") or 0.0)
    resp.device_time.fetch_ms = float(dt.get("fetchMs") or 0.0)
    resp.device_time.device_ms = float(dt.get("deviceMs") or 0.0)


def _device_time_from_proto(resp) -> Optional[dict]:
    """The HTTP-shaped deviceTime, or None when the server sent none."""
    if not resp.HasField("device_time"):
        return None
    return {"dwellMs": resp.device_time.dwell_ms, "execMs": resp.device_time.exec_ms,
            "fetchMs": resp.device_time.fetch_ms, "deviceMs": resp.device_time.device_ms}


# ------------------------------------------------------------------ server


def serve_grpc(service, port: int = 0):
    """Serve ``service`` over gRPC on 127.0.0.1 (``:364``); returns (server,
    port). Stop it with ``server.stop(grace)``."""
    from concurrent import futures

    import grpc

    p = pb2()

    def _abort_stale(ctx, exc):
        # the current epoch rides the details: the client resyncs and
        # re-stamps in one round trip (HTTP: 409 with staleEpoch)
        ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, f"stale epoch; current={exc.epoch}")

    def _abort_conflict(ctx, exc):
        # another client owns the pod or this session was fenced (HTTP: 409
        # with conflict): rejoin and requeue, never a transport retry
        ctx.abort(grpc.StatusCode.ABORTED, f"commit conflict: {exc}")

    def apply_deltas(request, ctx):
        try:
            out = service.apply_deltas(_deltas_from_proto(request))
        except StaleEpochError as exc:
            _abort_stale(ctx, exc)
        except ConflictError as exc:
            _abort_conflict(ctx, exc)
        return p.ApplyDeltasResponse(nodes=int(out.get("nodes", 0)), epoch=out.get("epoch", ""),
                                     delta_seq=int(out.get("deltaSeq", 0)),
                                     session_gen=int(out.get("sessionGen") or 0))

    def schedule_batch(request, ctx):
        try:
            out = service.schedule_batch(_batch_from_proto(request))
        except StaleEpochError as exc:
            _abort_stale(ctx, exc)
        except ConflictError as exc:
            _abort_conflict(ctx, exc)
        resp = _results_to_proto(out)
        resp.epoch = out.get("epoch", "")
        resp.delta_seq = int(out.get("deltaSeq", 0))
        resp.session_gen = int(out.get("sessionGen") or 0)
        resp.batch_id = out.get("batchId") or ""
        _device_time_to_proto(resp, out)
        return resp

    def heartbeat(request, ctx):
        req = _session_from_proto(request)
        if request.replicator:
            req["replicator"] = True
        try:
            out = service.heartbeat(req)
        except ConflictError as exc:
            _abort_conflict(ctx, exc)
        resp = p.HeartbeatResponse(
            epoch=out.get("epoch", ""), session_gen=int(out.get("sessionGen") or 0),
            sessions=int(out.get("sessions") or 0),
            lease_ttl_s=float(out.get("leaseTtlS") or 0.0),
            delta_seq=int(out.get("deltaSeq") or 0))
        resp.fenced.extend(out.get("fenced") or ())
        return resp

    def sessions_dump(request, ctx):
        return p.SessionsResponse(sessions_json=json.dumps(service.sessions_dump({})).encode())

    def health(request, ctx):
        out = service.health({})
        return p.HealthResponse(status=out.get("status", "serving"), epoch=out.get("epoch", ""),
                                delta_seq=int(out.get("deltaSeq", 0)),
                                nodes=int(out.get("nodes", 0)))

    def handler(fn, req_cls, resp_cls):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString)

    handlers = grpc.method_handlers_generic_handler(SERVICE, {
        "ApplyDeltas": handler(apply_deltas, p.ApplyDeltasRequest, p.ApplyDeltasResponse),
        "ScheduleBatch": handler(schedule_batch, p.ScheduleBatchRequest,
                                 p.ScheduleBatchResponse),
        "Health": handler(health, p.HealthRequest, p.HealthResponse),
        "Heartbeat": handler(heartbeat, p.HeartbeatRequest, p.HeartbeatResponse),
        "Sessions": handler(sessions_dump, p.SessionsRequest, p.SessionsResponse),
    })
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((handlers,))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, bound


# ------------------------------------------------------------------ client


class GrpcClient:
    """``WireClient`` over gRPC (``:477``): the same dict payloads, retry
    policy, error taxonomy and fault hook. ``close`` releases the channel."""

    _STALE_PREFIX = "stale epoch; current="

    # the port's vendored schema carries claims, Health and the session verbs
    supports_dra = True
    supports_health = True
    supports_sessions = True

    def __init__(self, endpoint: str, read_timeout: float = 60.0,
                 retry: Optional[RetryPolicy] = None, fault_plan=None):
        import grpc

        p = pb2()
        self.endpoint = endpoint
        self.read_timeout = read_timeout
        self.retry = retry if retry is not None else RetryPolicy()
        self.fault_plan = fault_plan
        self._grpc = grpc
        self._channel = grpc.insecure_channel(endpoint)

        def stub(method, req_cls, resp_cls):
            return self._channel.unary_unary(
                f"/{SERVICE}/{method}", request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)

        self._apply = stub("ApplyDeltas", p.ApplyDeltasRequest, p.ApplyDeltasResponse)
        self._schedule = stub("ScheduleBatch", p.ScheduleBatchRequest, p.ScheduleBatchResponse)
        self._health = stub("Health", p.HealthRequest, p.HealthResponse)
        self._heartbeat = stub("Heartbeat", p.HeartbeatRequest, p.HeartbeatResponse)
        self._sessions = stub("Sessions", p.SessionsRequest, p.SessionsResponse)

    def _call(self, op: str, stub, request):
        grpc = self._grpc

        def attempt():
            raise_injected_fault(self.fault_plan, op, self.read_timeout)
            try:
                return stub(request, timeout=self.read_timeout)
            except grpc.RpcError as e:
                code = e.code()
                details = e.details() or ""
                if code == grpc.StatusCode.FAILED_PRECONDITION:
                    epoch = ""
                    if self._STALE_PREFIX in details:
                        epoch = details.split(self._STALE_PREFIX, 1)[1].strip()
                    raise StaleEpochError(epoch, details) from e
                if code == grpc.StatusCode.ABORTED:
                    raise ConflictError(details or "commit conflict") from e
                if code in (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED,
                            grpc.StatusCode.RESOURCE_EXHAUSTED):
                    raise TransientDeviceError(f"device service {code.name}: {details}") from e
                raise PermanentDeviceError(f"device service {code.name}: {details}") from e

        return self.retry.run(op, attempt)

    @staticmethod
    def _session_gen_out(resp, out: dict) -> dict:
        if resp.session_gen:
            out["sessionGen"] = int(resp.session_gen)
        return out

    def apply_deltas(self, payload: dict) -> dict:
        resp = self._call("apply_deltas", self._apply, _deltas_to_proto(payload))
        out = {"nodes": resp.nodes}
        if resp.epoch:
            out["epoch"] = resp.epoch
            out["deltaSeq"] = resp.delta_seq
        return self._session_gen_out(resp, out)

    def schedule_batch(self, payload: dict) -> dict:
        resp = self._call("schedule_batch", self._schedule, _batch_to_proto(payload))
        out = _results_from_proto(resp)
        if resp.epoch:
            out["epoch"] = resp.epoch
            out["deltaSeq"] = resp.delta_seq
        if resp.batch_id:
            # the echoed idempotency key routes a pipelined reply
            out["batchId"] = resp.batch_id
        dt = _device_time_from_proto(resp)
        if dt is not None:
            out["deviceTime"] = dt
        return self._session_gen_out(resp, out)

    def heartbeat(self, payload: dict) -> dict:
        """Lease renewal and the takeover signal."""
        req = pb2().HeartbeatRequest(client_id=payload.get("clientId") or "",
                                     session_gen=int(payload.get("sessionGen") or 0),
                                     replicator=bool(payload.get("replicator")))
        resp = self._call("heartbeat", self._heartbeat, req)
        return {"epoch": resp.epoch, "sessionGen": int(resp.session_gen),
                "sessions": int(resp.sessions), "fenced": list(resp.fenced),
                "leaseTtlS": float(resp.lease_ttl_s), "deltaSeq": int(resp.delta_seq)}

    def sessions_dump(self) -> dict:
        """The service's session table (the /debug/sessions passthrough)."""
        resp = self._call("sessions", self._sessions, pb2().SessionsRequest())
        return json.loads(resp.sessions_json or b"{}")

    def health(self) -> dict:
        """The cheap liveness and identity verb (the half-open probe)."""
        resp = self._call("health", self._health, pb2().HealthRequest())
        return {"status": resp.status, "epoch": resp.epoch, "deltaSeq": resp.delta_seq,
                "nodes": resp.nodes}

    def close(self) -> None:
        self._channel.close()
