# Generated by tools/gen_torch_api_pb2.py from kubernetes_tpu_torch/native/
# ktpu_api.proto; DO NOT EDIT. After editing the .proto, regenerate with
#
#     python tools/gen_torch_api_pb2.py
#
# api/protobuf.pb2() uses this module only while PROTO_SHA256 matches the
# .proto beside it.
"""Vendored protobuf messages of the API objects' wire form (KValue)."""

from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf.internal import builder as _builder

PROTO_SHA256 = "cea560a831a28d1c8da4c7a6be5fca26ee423270b6d98bfc0f637b6665208f1b"

DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(
    b'\n\x0ektpu_api.proto\x12\x0bktpu.api.v1"\x99\x01\n\x06KValue\x12\x0b\n\x01s\x18\x01 '
    b'\x01(\tH\x00\x12\x0b\n\x01i\x18\x02 \x01(\x12H\x00\x12\x0b\n\x01d\x18\x03 \x01(\x01H\x00\x12\x0b\n\x01b\x18\x04 \x01(\x08H\x00\x12"\n\x04'
    b'list\x18\x05 \x01(\x0b2\x12.ktpu.api.v1.KListH\x00\x12 \n\x03map\x18\x06 \x01(\x0b2\x11.'
    b'ktpu.api.v1.KMapH\x00\x12\r\n\x03raw\x18\x07 \x01(\x0cH\x00B\x06\n\x04kind"+\n\x05KLi'
    b'st\x12"\n\x05items\x18\x01 \x03(\x0b2\x13.ktpu.api.v1.KValue"y\n\x04KMap\x12-'
    b'\n\x06fields\x18\x01 \x03(\x0b2\x1d.ktpu.api.v1.KMap.FieldsEntry\x1aB\n'
    b'\x0bFieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12"\n\x05value\x18\x02 \x01(\x0b2\x13.ktpu.'
    b'api.v1.KValue:\x028\x01"P\n\x07KObject\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x13\n\x0bap'
    b'i_version\x18\x02 \x01(\t\x12"\n\x05value\x18\x03 \x01(\x0b2\x13.ktpu.api.v1.KVa'
    b'lue"Z\n\x0bKObjectList\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12#\n\x05items\x18\x02 \x03(\x0b2'
    b'\x14.ktpu.api.v1.KObject\x12\x18\n\x10resource_version\x18\x03 \x01(\x03b'
    b'\x06proto3'
)

_globals = globals()
_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, _globals)
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, "ktpu_api_pb2", _globals)
