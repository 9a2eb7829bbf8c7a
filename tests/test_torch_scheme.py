"""The port's wire schemes against the JAX package's: the core/v1 manifest
conversions (``api/corev1.py``) through the versioned scheme
(``api/scheme.py``), and the protobuf form (``api/protobuf.py`` over the
vendored ``native/ktpu_api_pb2.py``).

Every object is made from one seeded numpy generator (``--seed`` of the
module: ``SEED``) by filling each field of its dataclass by its type hint,
then rebuilt as the JAX package's (``to_jax``). Exact equality throughout:
manifests, defaulted decodes (by their wire form), protobuf bytes both
ways, and the descriptor's serialized bytes. The port's protobuf needs no
``protoc``: it imports and encodes with ``shutil.which("protoc")`` patched
to None and every subprocess refused, and in a child interpreter whose
``PATH`` is empty."""

from __future__ import annotations

import dataclasses
import importlib
import os
import shutil
import subprocess
import sys
import typing

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_cases import (build_nodes, build_pods, build_topo_pods, cluster_spec,  # noqa: E402
                          pods_spec, to_jax, topo_pods_spec, torch_api)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 24


def sample(tp, rng, depth: int = 0, name: str = "x"):
    """A value of type ``tp`` (a port API dataclass or a field's hint)
    drawn from ``rng``: strings, numbers, optionals, tuples, lists, dicts
    and nested dataclasses, a few levels deep."""
    from kubernetes_tpu_torch.api import types as T

    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if tp is str:
        return f"{name}-{int(rng.integers(0, 1000))}"
    if tp is bool:
        return bool(rng.integers(0, 2))
    if tp is int:
        return int(rng.integers(0, 100))
    if tp is float:
        return float(rng.integers(0, 100)) / 4
    if tp is object or tp is typing.Any:
        return f"{name}-{int(rng.integers(0, 10))}"
    if origin is typing.Union:
        inner = next(a for a in args if a is not type(None))
        return None if depth > 2 or rng.integers(0, 3) == 0 else sample(inner, rng, depth, name)
    if origin in (tuple, list):
        items = [sample(args[0], rng, depth + 1, name)
                 for _ in range(0 if depth > 2 else int(rng.integers(0, 3)))]
        return tuple(items) if origin is tuple else items
    if origin is dict:
        vt = str if args[1] in (object, typing.Any) else args[1]
        return {f"k{int(rng.integers(0, 9))}": sample(vt, rng, depth + 1, name)
                for _ in range(int(rng.integers(0, 3)))}
    if dataclasses.is_dataclass(tp):
        if depth > 3:
            return tp()
        hints = typing.get_type_hints(tp, vars(T))
        return tp(**{f.name: sample(hints[f.name], rng, depth + 1, f.name)
                     for f in dataclasses.fields(tp) if f.init})
    raise TypeError(tp)


def _schemes():
    from kubernetes_tpu.api.scheme import default_scheme as jax_scheme
    from kubernetes_tpu_torch.api.scheme import default_scheme

    return jax_scheme(), default_scheme()


def _wire(obj):
    from kubernetes_tpu_torch.api.codec import to_wire

    return to_wire(obj)


def _jwire(obj):
    from kubernetes_tpu.api.codec import to_wire

    return to_wire(obj)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as err:  # noqa: BLE001 - the outcome is compared
        return type(err).__name__, str(err)


def _scheme_objects(kind: str, cls, rng, n: int = 6) -> list:
    """``n`` seeded objects of a registered kind; pods and nodes also from
    the loop tests' specs (affinity, spread, tolerations, ports)."""
    objs = [sample(cls, rng) for _ in range(n)]
    if kind == "Pod":
        objs += build_pods(torch_api(), pods_spec(8, SEED))
        objs += build_topo_pods(torch_api(), topo_pods_spec(8, SEED))
    if kind == "Node":
        objs += [ni.node for ni in build_nodes(torch_api(), cluster_spec(6, SEED))]
    return objs


def test_every_kind_manifest_round_trip_equals_jax():
    jscheme, tscheme = _schemes()
    assert [(g.group, g.version, g.kind) for g in tscheme.registered_kinds()] == [
        (g.group, g.version, g.kind) for g in jscheme.registered_kinds()]
    rng = np.random.default_rng(SEED)
    seen = 0
    for gvk in tscheme.registered_kinds():
        cls = tscheme._kinds[gvk][0]
        for obj in _scheme_objects(gvk.kind, cls, rng):
            jobj = to_jax(obj)
            manifest = tscheme.encode(obj)
            assert manifest == jscheme.encode(jobj), gvk
            # each package decodes the manifest to equal, defaulted objects
            tdec, jdec = tscheme.decode(manifest), jscheme.decode(manifest)
            assert _wire(tdec) == _jwire(jdec), gvk
            assert tscheme.encode(tdec) == jscheme.encode(jdec), gvk
            assert tscheme.encode_json(tdec) == jscheme.encode_json(jdec), gvk
            seen += 1
    assert seen > 18 * 6


def test_scheme_errors_equal():
    jscheme, tscheme = _schemes()
    for doc in ({"apiVersion": "v9", "kind": "Pod"}, {"apiVersion": "v1"}, [1],
                {"apiVersion": "v1", "kind": "Nope", "metadata": {}}):
        assert _outcome(lambda: tscheme.decode(doc)) == _outcome(lambda: jscheme.decode(doc))
    from kubernetes_tpu_torch.api.types import Lease

    assert _outcome(lambda: tscheme.encode(Lease()))[0] == "SchemeError"


def test_meta_from_equals_jax():
    from kubernetes_tpu.api.corev1 import meta_from as jmeta_from
    from kubernetes_tpu_torch.api.corev1 import meta_from

    md = {"name": "a", "namespace": "ns", "uid": 7, "labels": {"x": "1"},
          "annotations": {"y": "2"}, "finalizers": ["f"],
          "ownerReferences": [{"kind": "ReplicaSet", "name": "rs", "controller": True,
                               "blockOwnerDeletion": True}]}
    assert _wire(meta_from(md)) == _jwire(jmeta_from(md))


def _api_dataclasses():
    from kubernetes_tpu_torch.api import types as T

    return [getattr(T, n) for n in sorted(dir(T))
            if isinstance(getattr(T, n), type) and dataclasses.is_dataclass(getattr(T, n))
            and getattr(T, n).__module__ == T.__name__]


def test_protobuf_object_and_list_bytes_equal_both_ways():
    from kubernetes_tpu.api import protobuf as jpb
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu_torch.api import protobuf as tpb

    rng = np.random.default_rng(SEED + 1)
    kinds = 0
    for cls in _api_dataclasses():
        kind = cls.__name__
        if not hasattr(jtypes, kind):
            continue  # the RBAC objects live in the JAX package's auth module
        objs = [sample(cls, rng) for _ in range(3)]
        for obj in objs:
            data = tpb.encode_object(kind, obj)
            assert data == jpb.encode_object(kind, to_jax(obj)), kind
            got_kind, back = jpb.decode_object(data)
            assert got_kind == kind and _jwire(back) == _wire(obj), kind
            got_kind, back = tpb.decode_object(jpb.encode_object(kind, to_jax(obj)))
            assert got_kind == kind and _wire(back) == _wire(obj), kind
        data = tpb.encode_list(kind, objs, resource_version=41)
        assert data == jpb.encode_list(kind, [to_jax(o) for o in objs], resource_version=41)
        jk, jobjs, jrv = jpb.decode_list(data)
        tk, tobjs, trv = tpb.decode_list(data)
        assert (jk, jrv) == (tk, trv) == (kind, 41)
        assert [_jwire(o) for o in jobjs] == [_wire(o) for o in tobjs] == [_wire(o) for o in objs]
        kinds += 1
    assert kinds >= 60


def test_protobuf_errors_equal():
    from kubernetes_tpu.api import protobuf as jpb
    from kubernetes_tpu_torch.api import protobuf as tpb

    for data in (b"nope", tpb.MAGIC + b"\x0a\x04Nope"):
        assert _outcome(lambda: tpb.decode_object(data)) == _outcome(
            lambda: jpb.decode_object(data))
        assert _outcome(lambda: tpb.decode_list(data))[0] == _outcome(
            lambda: jpb.decode_list(data))[0]
    assert _outcome(lambda: tpb.encode_object("Pod", {1, 2})) == _outcome(
        lambda: jpb.encode_object("Pod", {1, 2}))


def test_descriptor_bytes_equal_jax():
    from kubernetes_tpu.api import protobuf as jpb
    from kubernetes_tpu_torch.api import protobuf as tpb

    assert tpb.pb2().DESCRIPTOR.serialized_pb == jpb.pb2().DESCRIPTOR.serialized_pb
    assert tpb.pb2().DESCRIPTOR.name == "ktpu_api.proto"


def test_vendored_module_is_current():
    """The vendored module records the hash of the port's ``.proto``, and
    with protoc on PATH ``tools/gen_torch_api_pb2.py --check`` regenerates
    it byte for byte."""
    sys.path.insert(0, ROOT)
    from tools import gen_torch_api_pb2 as gen

    assert gen.vendored_sha256(gen.OUT) == gen.proto_sha256(gen.PROTO)
    if shutil.which("protoc") is not None:
        with open(gen.OUT, encoding="utf-8") as f:
            assert f.read() == gen.generate()
        assert gen.descriptor_bytes() == gen.descriptor_bytes(os.path.join(ROOT, "native",
                                                                           "ktpu_api.proto"))
    assert gen.main(["--check"]) == 0


def test_stale_vendored_module_raises(tmp_path, monkeypatch):
    """An edited ``.proto`` without a regenerated module: ``pb2()`` raises
    and names the generator; nothing is built in its place."""
    from kubernetes_tpu_torch.api import protobuf as tpb

    edited = tmp_path / "ktpu_api.proto"
    with open(tpb._PROTO, encoding="utf-8") as f:
        edited.write_text(f.read() + "\nmessage Extra {}\n")
    monkeypatch.setattr(tpb, "_PROTO", str(edited))
    monkeypatch.setattr(tpb, "_pb2", None)
    assert not tpb.pb2_available()
    with pytest.raises(RuntimeError, match="gen_torch_api_pb2"):
        tpb.pb2()


def test_protobuf_needs_no_protoc(monkeypatch):
    from kubernetes_tpu_torch.api import protobuf as tpb
    from kubernetes_tpu_torch.api.types import Pod

    def refuse(*a, **kw):
        raise AssertionError(f"subprocess {a}")

    monkeypatch.setattr(shutil, "which", lambda name, *a, **kw: None)
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    mod = importlib.reload(tpb)
    try:
        assert mod.pb2_available()
        pod = sample(Pod, np.random.default_rng(SEED))
        kind, back = mod.decode_object(mod.encode_object("Pod", pod))
        assert kind == "Pod" and _wire(back) == _wire(pod)
    finally:
        monkeypatch.undo()
        importlib.reload(tpb)


def test_protobuf_and_http_front_import_without_protoc_on_path():
    code = ("from kubernetes_tpu_torch.api import protobuf\n"
            "from kubernetes_tpu_torch.apiserver import http\n"
            "from kubernetes_tpu_torch.api.types import Node, ObjectMeta\n"
            "n = Node(meta=ObjectMeta(name='n1', namespace=''))\n"
            "k, back = protobuf.decode_object(protobuf.encode_object('Node', n))\n"
            "assert k == 'Node' and back.meta.name == 'n1'\n"
            "import shutil; assert shutil.which('protoc') is None\n"
            "print('ok')\n")
    env = {"PATH": "", "PYTHONPATH": ROOT, "HOME": os.environ.get("HOME", "/tmp")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
