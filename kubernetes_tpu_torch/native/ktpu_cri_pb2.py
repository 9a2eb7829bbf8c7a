# Generated by tools/gen_torch_cri_pb2.py from kubernetes_tpu_torch/native/
# ktpu_cri.proto; DO NOT EDIT. After editing the .proto, regenerate with
#
#     python tools/gen_torch_cri_pb2.py
#
# kubelet/cri.pb2() uses this module only while PROTO_SHA256 matches the
# .proto beside it.
"""Vendored protobuf messages of the kubelet's reduced CRI (ktpu.cri.v1)."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

PROTO_SHA256 = "ad32be609d2b8ee0a552b16b3c28aeb658929a4061da844dd16743e373dff445"

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
    b'\n\x0ektpu_cri.proto\x12\x0bktpu.cri.v1"!\n\x0eVersionRequest\x12'
    b'\x0f\n\x07version\x18\x01 \x01(\t"Q\n\x0fVersionResponse\x12\x0f\n\x07version\x18\x01'
    b' \x01(\t\x12\x14\n\x0cruntime_name\x18\x02 \x01(\t\x12\x17\n\x0fruntime_version\x18\x03 '
    b'\x01(\t"\xa3\x02\n\x10PodSandboxConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamesp'
    b'ace\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t\x129\n\x06labels\x18\x04 \x03(\x0b2).ktpu.cr'
    b'i.v1.PodSandboxConfig.LabelsEntry\x12C\n\x0bannotations'
    b'\x18\x05 \x03(\x0b2..ktpu.cri.v1.PodSandboxConfig.Annotation'
    b'sEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01('
    b'\t:\x028\x01\x1a2\n\x10AnnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18'
    b'\x02 \x01(\t:\x028\x01"E\n\x14RunPodSandboxRequest\x12-\n\x06config\x18\x01 \x01('
    b'\x0b2\x1d.ktpu.cri.v1.PodSandboxConfig"/\n\x15RunPodSandbo'
    b'xResponse\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t"/\n\x15StopPodSand'
    b'boxRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t"\x18\n\x16StopPodSan'
    b'dboxResponse"1\n\x17RemovePodSandboxRequest\x12\x16\n\x0epod_s'
    b'andbox_id\x18\x01 \x01(\t"\x1a\n\x18RemovePodSandboxResponse"\x88\x01\n\n'
    b'PodSandbox\x12\n\n\x02id\x18\x01 \x01(\t\x12-\n\x06config\x18\x02 \x01(\x0b2\x1d.ktpu.cr'
    b'i.v1.PodSandboxConfig\x12+\n\x05state\x18\x03 \x01(\x0e2\x1c.ktpu.cri.'
    b'v1.PodSandboxState\x12\x12\n\ncreated_at\x18\x04 \x01(\x03"\x17\n\x15ListPo'
    b'dSandboxRequest"@\n\x16ListPodSandboxResponse\x12&\n\x05ite'
    b'ms\x18\x01 \x03(\x0b2\x17.ktpu.cri.v1.PodSandbox"1\n\x17PodSandboxS'
    b'tatusRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t"C\n\x18PodSandb'
    b"oxStatusResponse\x12'\n\x06status\x18\x01 \x01(\x0b2\x17.ktpu.cri.v1.P"
    b'odSandbox"F\n\x0fContainerConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05im'
    b'age\x18\x02 \x01(\t\x12\x16\n\x0epod_sandbox_id\x18\x03 \x01(\t"^\n\x16CreateConta'
    b'inerRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\x12,\n\x06config\x18\x02 '
    b'\x01(\x0b2\x1c.ktpu.cri.v1.ContainerConfig"/\n\x17CreateConta'
    b'inerResponse\x12\x14\n\x0ccontainer_id\x18\x01 \x01(\t"-\n\x15StartConta'
    b'inerRequest\x12\x14\n\x0ccontainer_id\x18\x01 \x01(\t"\x18\n\x16StartContai'
    b'nerResponse"=\n\x14StopContainerRequest\x12\x14\n\x0ccontainer'
    b'_id\x18\x01 \x01(\t\x12\x0f\n\x07timeout\x18\x02 \x01(\x03"\x17\n\x15StopContainerRespo'
    b'nse".\n\x16RemoveContainerRequest\x12\x14\n\x0ccontainer_id\x18\x01 '
    b'\x01(\t"\x19\n\x17RemoveContainerResponse"\xc1\x01\n\tContainer\x12\n\n\x02'
    b'id\x18\x01 \x01(\t\x12,\n\x06config\x18\x02 \x01(\x0b2\x1c.ktpu.cri.v1.Container'
    b'Config\x12*\n\x05state\x18\x03 \x01(\x0e2\x1b.ktpu.cri.v1.ContainerSta'
    b'te\x12\x12\n\ncreated_at\x18\x04 \x01(\x03\x12\x12\n\nstarted_at\x18\x05 \x01(\x03\x12\x13\n\x0bfi'
    b'nished_at\x18\x06 \x01(\x03\x12\x11\n\texit_code\x18\x07 \x01(\x05"/\n\x15ListContai'
    b'nersRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t"D\n\x16ListConta'
    b'inersResponse\x12*\n\ncontainers\x18\x01 \x03(\x0b2\x16.ktpu.cri.v1.'
    b'Container".\n\x16ContainerStatusRequest\x12\x14\n\x0ccontainer'
    b'_id\x18\x01 \x01(\t"A\n\x17ContainerStatusResponse\x12&\n\x06status\x18\x01'
    b' \x01(\x0b2\x16.ktpu.cri.v1.Container"\x1a\n\tImageSpec\x12\r\n\x05ima'
    b'ge\x18\x01 \x01(\t"9\n\x10PullImageRequest\x12%\n\x05image\x18\x01 \x01(\x0b2\x16.kt'
    b'pu.cri.v1.ImageSpec"&\n\x11PullImageResponse\x12\x11\n\timag'
    b'e_ref\x18\x01 \x01(\t"\x13\n\x11ListImagesRequest"4\n\x05Image\x12\n\n\x02id\x18'
    b'\x01 \x01(\t\x12\x11\n\trepo_tags\x18\x02 \x03(\t\x12\x0c\n\x04size\x18\x03 \x01(\x04"8\n\x12ListIm'
    b'agesResponse\x12"\n\x06images\x18\x01 \x03(\x0b2\x12.ktpu.cri.v1.Image'
    b'";\n\x12RemoveImageRequest\x12%\n\x05image\x18\x01 \x01(\x0b2\x16.ktpu.cri'
    b'.v1.ImageSpec"\x15\n\x13RemoveImageResponse*:\n\x0fPodSandb'
    b'oxState\x12\x11\n\rSANDBOX_READY\x10\x00\x12\x14\n\x10SANDBOX_NOTREADY\x10\x01'
    b'*T\n\x0eContainerState\x12\x15\n\x11CONTAINER_CREATED\x10\x00\x12\x15\n\x11CON'
    b'TAINER_RUNNING\x10\x01\x12\x14\n\x10CONTAINER_EXITED\x10\x02b\x06proto3'
)

_globals = globals()
_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, _globals)
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "ktpu_cri_pb2", _globals)
