"""Runtime-assembled proto messages (no protoc in the image).

``ReportPiecesFinishedRequest`` — the batched piece-report request — is
declared in ``dragonfly.proto`` for schema documentation, but the image
carries no protoc to regenerate ``dragonfly_pb2.py``.  This module
assembles the identical ``FileDescriptorProto`` at import time and adds
it to the default descriptor pool, which is wire-compatible with codegen
output (the generated module does exactly this with a serialized blob).
If a future regeneration bakes the message into ``dragonfly_pb2``, that
definition wins and this one is skipped.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from . import dragonfly_pb2  # registers dragonfly.proto in the pool


def _build():
    # A regenerated dragonfly_pb2 that already carries the message wins —
    # adding a second definition to the pool would collide.
    existing = getattr(dragonfly_pb2, "ReportPiecesFinishedRequest", None)
    if existing is not None:
        return existing
    pool = descriptor_pool.Default()
    try:
        fd = pool.FindFileByName("dragonfly_batch.proto")
    except KeyError:
        fdp = descriptor_pb2.FileDescriptorProto()
        fdp.name = "dragonfly_batch.proto"
        fdp.package = "dragonfly2tpu"
        fdp.syntax = "proto3"
        fdp.dependency.append("dragonfly.proto")
        msg = fdp.message_type.add()
        msg.name = "ReportPiecesFinishedRequest"
        f1 = msg.field.add()
        f1.name, f1.number = "peer_id", 1
        f1.type = descriptor_pb2.FieldDescriptorProto.TYPE_STRING
        f1.label = descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL
        f2 = msg.field.add()
        f2.name, f2.number = "pieces", 2
        f2.type = descriptor_pb2.FieldDescriptorProto.TYPE_MESSAGE
        f2.type_name = ".dragonfly2tpu.ReportPieceFinishedRequest"
        f2.label = descriptor_pb2.FieldDescriptorProto.LABEL_REPEATED
        fd = pool.Add(fdp)
    desc = fd.message_types_by_name["ReportPiecesFinishedRequest"]
    try:
        return message_factory.GetMessageClass(desc)
    except AttributeError:  # protobuf < 4.21 spelling
        return message_factory.MessageFactory(pool).GetPrototype(desc)


ReportPiecesFinishedRequest = _build()
