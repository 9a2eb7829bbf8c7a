"""The port's copy of the device service's wire schema
(``ktpu_device.proto``) and its vendored message module
(``ktpu_device_pb2.py``, written by ``tools/gen_torch_pb2.py``). Nothing
here is imported until the gRPC transport asks for it
(``backend/grpc_service.pb2``)."""
