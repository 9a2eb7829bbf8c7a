"""CRI seam: the kubelet ⇄ container-runtime gRPC boundary
(staging/src/k8s.io/cri-api/pkg/apis/runtime/v1/api.proto; remote client
pkg/kubelet/cri/remote/); an own copy of ``kubernetes_tpu/kubelet/cri.py``.

Three pieces:
  * ``FakeRuntimeService`` — an in-process runtime holding the
    sandbox/container state machines (the kubemark hollow-kubelet injected
    fake CRI, pkg/kubemark/hollow_kubelet.go:95).
  * ``serve_cri``/``CRIClient`` — real gRPC bindings over
    ``native/ktpu_cri.proto`` (generic method handlers, like the device
    service). The messages come from the vendored ``native/ktpu_cri_pb2.py``
    (``tools/gen_torch_cri_pb2.py``), used only while its ``PROTO_SHA256``
    matches the ``.proto`` beside it; a stale or missing one raises, and no
    ``protoc`` is ever run. Its descriptor bytes are the JAX package's, so
    both register in one process and each decodes the other's bytes.
  * ``HollowKubelet`` integration — pass ``runtime=`` (fake or client) and
    the syncLoop materializes pod phases through RunPodSandbox /
    CreateContainer / StartContainer / StopPodSandbox instead of bare
    status writes (kubelet.go:1502 syncPod's runtime calls).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..native import proto_sha256, vendored_sha256

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_PROTO = os.path.join(_NATIVE, "ktpu_cri.proto")
_VENDORED = os.path.join(_NATIVE, "ktpu_cri_pb2.py")

_pb2 = None
_pb2_lock = threading.Lock()

SERVICE = "ktpu.cri.v1.RuntimeService"
RUNTIME_NAME = "ktpu-hollow"
RUNTIME_VERSION = "v1"


def _vendored_matches() -> bool:
    """The vendored module records the hash of the ``.proto`` beside it."""
    try:
        return vendored_sha256(_VENDORED) == proto_sha256(_PROTO)
    except OSError:
        return False


def pb2_available() -> bool:
    """True when ``pb2()`` will succeed."""
    return _pb2 is not None or _vendored_matches()


def pb2():
    """The vendored message module; RuntimeError when it is stale or
    missing."""
    global _pb2
    if _pb2 is not None:
        return _pb2
    with _pb2_lock:
        if _pb2 is None:
            if not _vendored_matches():
                raise RuntimeError(
                    "the vendored kubernetes_tpu_torch/native/ktpu_cri_pb2.py is stale or "
                    "missing; run `python tools/gen_torch_cri_pb2.py`")
            from ..native import ktpu_cri_pb2

            _pb2 = ktpu_cri_pb2
        return _pb2


class FakeRuntimeService:
    """Sandbox/container state machines behind the CRI method surface.
    Method names and transitions mirror the reference service
    (api.proto rpcs); ids are deterministic per (namespace, name)."""

    def __init__(self, now_fn=time.monotonic):
        self.now_fn = now_fn
        self._lock = threading.Lock()
        self.sandboxes: Dict[str, dict] = {}
        self.containers: Dict[str, dict] = {}
        self.images: Dict[str, dict] = {}
        self.calls: List[str] = []  # rpc journal (test observability)

    def _note(self, rpc: str) -> None:
        self.calls.append(rpc)

    # -- runtime

    def version(self) -> dict:
        self._note("Version")
        return {"version": "0.1.0", "runtime_name": RUNTIME_NAME,
                "runtime_version": RUNTIME_VERSION}

    def run_pod_sandbox(self, config: dict) -> str:
        self._note("RunPodSandbox")
        sid = f"sbx-{config.get('namespace', 'default')}-{config.get('name', '')}"
        with self._lock:
            self.sandboxes[sid] = {
                "id": sid, "config": dict(config), "state": "SANDBOX_READY",
                "created_at": int(self.now_fn() * 1e9),
            }
        return sid

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        self._note("StopPodSandbox")
        with self._lock:
            sb = self.sandboxes.get(sandbox_id)
            if sb is not None:
                sb["state"] = "SANDBOX_NOTREADY"
            for c in self.containers.values():
                if (c["config"].get("pod_sandbox_id") == sandbox_id
                        and c["state"] == "CONTAINER_RUNNING"):
                    c["state"] = "CONTAINER_EXITED"
                    c["finished_at"] = int(self.now_fn() * 1e9)
                    c["exit_code"] = 137

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        self._note("RemovePodSandbox")
        with self._lock:
            self.sandboxes.pop(sandbox_id, None)
            for cid in [c["id"] for c in self.containers.values()
                        if c["config"].get("pod_sandbox_id") == sandbox_id]:
                self.containers.pop(cid, None)

    def list_pod_sandbox(self) -> List[dict]:
        self._note("ListPodSandbox")
        with self._lock:
            return [dict(s) for s in self.sandboxes.values()]

    def pod_sandbox_status(self, sandbox_id: str) -> Optional[dict]:
        self._note("PodSandboxStatus")
        with self._lock:
            s = self.sandboxes.get(sandbox_id)
            return dict(s) if s else None

    # -- containers

    def create_container(self, sandbox_id: str, config: dict) -> str:
        self._note("CreateContainer")
        cid = f"ctr-{sandbox_id}-{config.get('name', '')}"
        with self._lock:
            self.containers[cid] = {
                "id": cid,
                "config": dict(config, pod_sandbox_id=sandbox_id),
                "state": "CONTAINER_CREATED",
                "created_at": int(self.now_fn() * 1e9),
                "started_at": 0, "finished_at": 0, "exit_code": 0,
            }
        image = config.get("image", "")
        if image:
            self.pull_image(image)
        return cid

    def start_container(self, container_id: str) -> None:
        self._note("StartContainer")
        with self._lock:
            c = self.containers.get(container_id)
            if c is None:
                raise KeyError(container_id)
            c["state"] = "CONTAINER_RUNNING"
            c["started_at"] = int(self.now_fn() * 1e9)

    def stop_container(self, container_id: str, timeout: int = 0) -> None:
        self._note("StopContainer")
        with self._lock:
            c = self.containers.get(container_id)
            if c is not None and c["state"] == "CONTAINER_RUNNING":
                c["state"] = "CONTAINER_EXITED"
                c["finished_at"] = int(self.now_fn() * 1e9)
                c["exit_code"] = 0

    def remove_container(self, container_id: str) -> None:
        self._note("RemoveContainer")
        with self._lock:
            self.containers.pop(container_id, None)

    def list_containers(self, sandbox_id: str = "") -> List[dict]:
        self._note("ListContainers")
        with self._lock:
            return [dict(c) for c in self.containers.values()
                    if not sandbox_id
                    or c["config"].get("pod_sandbox_id") == sandbox_id]

    def container_status(self, container_id: str) -> Optional[dict]:
        self._note("ContainerStatus")
        with self._lock:
            c = self.containers.get(container_id)
            return dict(c) if c else None

    # -- images

    def pull_image(self, image: str) -> str:
        self._note("PullImage")
        with self._lock:
            self.images.setdefault(image, {"id": f"img-{image}", "size": 1 << 20})
        return f"img-{image}"

    def list_images(self) -> List[dict]:
        self._note("ListImages")
        with self._lock:
            return [{"id": v["id"], "repo_tags": [k], "size": v["size"]}
                    for k, v in self.images.items()]

    def remove_image(self, image: str) -> None:
        self._note("RemoveImage")
        with self._lock:
            self.images.pop(image, None)


# ------------------------------------------------------------------ transport

_SANDBOX_STATES = ("SANDBOX_READY", "SANDBOX_NOTREADY")
_CONTAINER_STATES = ("CONTAINER_CREATED", "CONTAINER_RUNNING", "CONTAINER_EXITED")


def _sandbox_to_proto(p, s: dict):
    return p.PodSandbox(
        id=s["id"],
        config=p.PodSandboxConfig(**{
            k: v for k, v in s["config"].items()
            if k in ("name", "namespace", "uid", "labels", "annotations")}),
        state=_SANDBOX_STATES.index(s["state"]),
        created_at=s["created_at"])


def _container_to_proto(p, c: dict):
    cfg = c["config"]
    return p.Container(
        id=c["id"],
        config=p.ContainerConfig(name=cfg.get("name", ""),
                                 image=cfg.get("image", ""),
                                 pod_sandbox_id=cfg.get("pod_sandbox_id", "")),
        state=_CONTAINER_STATES.index(c["state"]),
        created_at=c["created_at"], started_at=c["started_at"],
        finished_at=c["finished_at"], exit_code=c["exit_code"])


def serve_cri(service: FakeRuntimeService, port: int = 0):
    """Bind the runtime to a localhost gRPC server; returns (server, port)."""
    import grpc
    from concurrent import futures

    p = pb2()

    def h(req_cls, resp_builder):
        return grpc.unary_unary_rpc_method_handler(
            lambda request, _ctx: resp_builder(request),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString())

    handlers = grpc.method_handlers_generic_handler(SERVICE, {
        "Version": h(p.VersionRequest, lambda r: p.VersionResponse(
            **service.version())),
        "RunPodSandbox": h(p.RunPodSandboxRequest, lambda r: p.RunPodSandboxResponse(
            pod_sandbox_id=service.run_pod_sandbox({
                "name": r.config.name, "namespace": r.config.namespace,
                "uid": r.config.uid, "labels": dict(r.config.labels),
                "annotations": dict(r.config.annotations)}))),
        "StopPodSandbox": h(p.StopPodSandboxRequest, lambda r: (
            service.stop_pod_sandbox(r.pod_sandbox_id), p.StopPodSandboxResponse())[1]),
        "RemovePodSandbox": h(p.RemovePodSandboxRequest, lambda r: (
            service.remove_pod_sandbox(r.pod_sandbox_id), p.RemovePodSandboxResponse())[1]),
        "ListPodSandbox": h(p.ListPodSandboxRequest, lambda r: p.ListPodSandboxResponse(
            items=[_sandbox_to_proto(p, s) for s in service.list_pod_sandbox()])),
        "PodSandboxStatus": h(p.PodSandboxStatusRequest, lambda r: p.PodSandboxStatusResponse(
            status=_sandbox_to_proto(p, service.pod_sandbox_status(r.pod_sandbox_id) or
                                     {"id": "", "config": {}, "state": "SANDBOX_NOTREADY",
                                      "created_at": 0}))),
        "CreateContainer": h(p.CreateContainerRequest, lambda r: p.CreateContainerResponse(
            container_id=service.create_container(r.pod_sandbox_id, {
                "name": r.config.name, "image": r.config.image}))),
        "StartContainer": h(p.StartContainerRequest, lambda r: (
            service.start_container(r.container_id), p.StartContainerResponse())[1]),
        "StopContainer": h(p.StopContainerRequest, lambda r: (
            service.stop_container(r.container_id, r.timeout), p.StopContainerResponse())[1]),
        "RemoveContainer": h(p.RemoveContainerRequest, lambda r: (
            service.remove_container(r.container_id), p.RemoveContainerResponse())[1]),
        "ListContainers": h(p.ListContainersRequest, lambda r: p.ListContainersResponse(
            containers=[_container_to_proto(p, c)
                        for c in service.list_containers(r.pod_sandbox_id)])),
        "ContainerStatus": h(p.ContainerStatusRequest, lambda r: p.ContainerStatusResponse(
            status=_container_to_proto(p, service.container_status(r.container_id) or {
                "id": "", "config": {}, "state": "CONTAINER_EXITED",
                "created_at": 0, "started_at": 0, "finished_at": 0, "exit_code": 0}))),
        "PullImage": h(p.PullImageRequest, lambda r: p.PullImageResponse(
            image_ref=service.pull_image(r.image.image))),
        "ListImages": h(p.ListImagesRequest, lambda r: p.ListImagesResponse(
            images=[p.Image(id=i["id"], repo_tags=i["repo_tags"], size=i["size"])
                    for i in service.list_images()])),
        "RemoveImage": h(p.RemoveImageRequest, lambda r: (
            service.remove_image(r.image.image), p.RemoveImageResponse())[1]),
    })
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((handlers,))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, bound


class CRIClient:
    """Remote runtime client (pkg/kubelet/cri/remote/remote_runtime.go):
    the same python surface as FakeRuntimeService, over the wire."""

    def __init__(self, endpoint: str):
        import grpc

        p = pb2()
        self._p = p
        self._channel = grpc.insecure_channel(endpoint)

        def rpc(name, req_cls, resp_cls):
            return self._channel.unary_unary(
                f"/{SERVICE}/{name}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)

        self._version = rpc("Version", p.VersionRequest, p.VersionResponse)
        self._run = rpc("RunPodSandbox", p.RunPodSandboxRequest, p.RunPodSandboxResponse)
        self._stop_sb = rpc("StopPodSandbox", p.StopPodSandboxRequest, p.StopPodSandboxResponse)
        self._rm_sb = rpc("RemovePodSandbox", p.RemovePodSandboxRequest, p.RemovePodSandboxResponse)
        self._list_sb = rpc("ListPodSandbox", p.ListPodSandboxRequest, p.ListPodSandboxResponse)
        self._create = rpc("CreateContainer", p.CreateContainerRequest, p.CreateContainerResponse)
        self._start = rpc("StartContainer", p.StartContainerRequest, p.StartContainerResponse)
        self._stop_c = rpc("StopContainer", p.StopContainerRequest, p.StopContainerResponse)
        self._list_c = rpc("ListContainers", p.ListContainersRequest, p.ListContainersResponse)
        self._images = rpc("ListImages", p.ListImagesRequest, p.ListImagesResponse)
        self._sb_status = rpc("PodSandboxStatus", p.PodSandboxStatusRequest,
                              p.PodSandboxStatusResponse)
        self._c_status = rpc("ContainerStatus", p.ContainerStatusRequest,
                             p.ContainerStatusResponse)
        self._rm_c = rpc("RemoveContainer", p.RemoveContainerRequest,
                         p.RemoveContainerResponse)
        self._pull = rpc("PullImage", p.PullImageRequest, p.PullImageResponse)
        self._rm_img = rpc("RemoveImage", p.RemoveImageRequest, p.RemoveImageResponse)

    def version(self) -> dict:
        r = self._version(self._p.VersionRequest())
        return {"version": r.version, "runtime_name": r.runtime_name,
                "runtime_version": r.runtime_version}

    def run_pod_sandbox(self, config: dict) -> str:
        return self._run(self._p.RunPodSandboxRequest(
            config=self._p.PodSandboxConfig(
                name=config.get("name", ""), namespace=config.get("namespace", ""),
                uid=config.get("uid", ""), labels=config.get("labels") or {},
            ))).pod_sandbox_id

    def stop_pod_sandbox(self, sandbox_id: str) -> None:
        self._stop_sb(self._p.StopPodSandboxRequest(pod_sandbox_id=sandbox_id))

    def remove_pod_sandbox(self, sandbox_id: str) -> None:
        self._rm_sb(self._p.RemovePodSandboxRequest(pod_sandbox_id=sandbox_id))

    def list_pod_sandbox(self) -> list:
        return [{"id": s.id, "state": _SANDBOX_STATES[s.state],
                 "config": {"name": s.config.name, "namespace": s.config.namespace}}
                for s in self._list_sb(self._p.ListPodSandboxRequest()).items]

    def create_container(self, sandbox_id: str, config: dict) -> str:
        return self._create(self._p.CreateContainerRequest(
            pod_sandbox_id=sandbox_id,
            config=self._p.ContainerConfig(name=config.get("name", ""),
                                           image=config.get("image", "")),
        )).container_id

    def start_container(self, container_id: str) -> None:
        self._start(self._p.StartContainerRequest(container_id=container_id))

    def stop_container(self, container_id: str, timeout: int = 0) -> None:
        self._stop_c(self._p.StopContainerRequest(container_id=container_id,
                                                  timeout=timeout))

    def list_containers(self, sandbox_id: str = "") -> list:
        return [{"id": c.id, "state": _CONTAINER_STATES[c.state],
                 "config": {"name": c.config.name, "image": c.config.image,
                            "pod_sandbox_id": c.config.pod_sandbox_id}}
                for c in self._list_c(
                    self._p.ListContainersRequest(pod_sandbox_id=sandbox_id)).containers]

    def list_images(self) -> list:
        return [{"id": i.id, "repo_tags": list(i.repo_tags), "size": i.size}
                for i in self._images(self._p.ListImagesRequest()).images]

    def pod_sandbox_status(self, sandbox_id: str) -> Optional[dict]:
        s = self._sb_status(self._p.PodSandboxStatusRequest(
            pod_sandbox_id=sandbox_id)).status
        if not s.id:
            return None
        return {"id": s.id, "state": _SANDBOX_STATES[s.state],
                "config": {"name": s.config.name, "namespace": s.config.namespace}}

    def container_status(self, container_id: str) -> Optional[dict]:
        c = self._c_status(self._p.ContainerStatusRequest(
            container_id=container_id)).status
        if not c.id:
            return None
        return {"id": c.id, "state": _CONTAINER_STATES[c.state],
                "exit_code": c.exit_code,
                "config": {"name": c.config.name, "image": c.config.image,
                           "pod_sandbox_id": c.config.pod_sandbox_id}}

    def remove_container(self, container_id: str) -> None:
        self._rm_c(self._p.RemoveContainerRequest(container_id=container_id))

    def pull_image(self, image: str) -> str:
        return self._pull(self._p.PullImageRequest(
            image=self._p.ImageSpec(image=image))).image_ref

    def remove_image(self, image: str) -> None:
        self._rm_img(self._p.RemoveImageRequest(
            image=self._p.ImageSpec(image=image)))

    def close(self) -> None:
        self._channel.close()
