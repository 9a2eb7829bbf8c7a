"""The API front pair the port's HTTP, auth and REST tests share: the JAX
``serve_api`` over a ``ClusterStore`` and the port's over a ``Store``, on one
constant clock (the JAX store stamps with ``time.time``, patched to it; the
port's with its ``now_fn``), each given its own package's ``AuthConfig``
built by the same function. ``request`` sends one request to both and
requires equal status codes and equal body bytes; ``both`` writes one
object to both stores directly (the JAX copy rebuilt by ``to_jax`` before
the port's store stamps it)."""

from __future__ import annotations

import http.client
import json
import time
from typing import Callable, Optional

from _torch_cases import to_jax

T0 = 1_700_000_000.0


def packages():
    """(JAX modules, port modules): each a dict of the front's modules."""
    import kubernetes_tpu.api.protobuf as jprotobuf
    import kubernetes_tpu.apiserver.auth as jauth
    import kubernetes_tpu.apiserver.http as jhttp
    import kubernetes_tpu.apiserver.store as jstore
    import kubernetes_tpu_torch.api.protobuf as tprotobuf
    import kubernetes_tpu_torch.apiserver.auth as tauth
    import kubernetes_tpu_torch.apiserver.http as thttp
    import kubernetes_tpu_torch.apiserver.store as tstore

    return ({"auth": jauth, "http": jhttp, "store": jstore, "protobuf": jprotobuf},
            {"auth": tauth, "http": thttp, "store": tstore, "protobuf": tprotobuf})


class FrontPair:
    def __init__(self, monkeypatch, auth: Optional[Callable] = None, serve: bool = True):
        """``auth(modules, store)`` gives one package's AuthConfig (or None)."""
        jmods, tmods = packages()
        self.now = T0
        monkeypatch.setattr(time, "time", lambda: self.now)
        self.jstore = jmods["store"].ClusterStore()
        self.tstore = tmods["store"].Store(now_fn=lambda: self.now)
        self.auth = auth
        self.servers = []
        self.ports = []
        if serve:
            self.serve()

    def serve(self) -> None:
        for mods, store in zip(packages(), (self.jstore, self.tstore)):
            cfg = self.auth(mods, store) if self.auth is not None else None
            server, port = mods["http"].serve_api(store, auth=cfg)
            self.servers.append((mods["http"], server))
            self.ports.append(port)

    def close(self) -> None:
        for http_mod, server in self.servers:
            http_mod.shutdown_api(server)
        self.servers, self.ports = [], []

    def both(self, method: str, obj, *args):
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

    @staticmethod
    def send(port: int, method: str, path: str, body=None, headers=None):
        """One request on a fresh connection: (status, content type, body)."""
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            hdrs = dict(headers or {})
            data = None
            if body is not None:
                data = body if isinstance(body, bytes) else json.dumps(body).encode()
                hdrs.setdefault("Content-Type", "application/json")
            conn.request(method, path, body=data, headers=hdrs)
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()

    def request(self, method: str, path: str, body=None, headers=None):
        """The same request to both fronts; equal status, content type and
        body bytes. Returns the port's (status, body)."""
        outs = [self.send(port, method, path, body, headers) for port in self.ports]
        assert outs[1] == outs[0], (method, path, outs)
        return outs[1][0], outs[1][2]

    def json(self, method: str, path: str, body=None, headers=None):
        code, raw = self.request(method, path, body, headers)
        return code, json.loads(raw) if raw else None
