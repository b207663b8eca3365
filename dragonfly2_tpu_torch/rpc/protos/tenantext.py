"""Runtime-assembled tenant-carrying scheduler messages (DESIGN.md §26).

The JSON dialect has carried a ``tenant`` field on announces and
registers since the QoS plane landed, but the checked-in
``dragonfly_pb2.py`` predates it — and the image carries no protoc to
regenerate.  ``dict_to_proto`` parses with ``ignore_unknown_fields``,
so on the gRPC wire the daemon's tenant stamp was silently DROPPED and
gRPC deployments degraded to the default tenant.

Like ``protos/batch.py``, this module assembles the extended messages
at import time in a sibling package (``dragonfly2tpu.tenantext``):

- ``RegisterPeerRequest``  — fields 1-7 identical to the base message,
  plus ``tenant = 8``;
- ``AnnounceHostRequest``  — ``host = 1`` / ``protocol_version = 2``
  identical, plus ``tenant = 3``;
- ``AnnouncePeerRequest``  — the bidi stream envelope, with the
  ``register`` arm retyped to the extended ``RegisterPeerRequest``
  (all other arms reference the base types).

Adding a field number is wire-compatible in both directions: an old
peer's bytes parse with ``tenant`` empty, and a new peer's bytes parse
on an old binary with the unknown field skipped (degrading, as
documented, to the default tenant).  If a future protoc regeneration
bakes ``tenant`` into ``dragonfly_pb2``, the base classes already
carry the field and this module hands them straight back.

Keep ``dragonfly.proto`` in sync — it documents these fields for the
day codegen returns.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from . import dragonfly_pb2 as pb

_FILE = "dragonfly_tenant.proto"
_PKG = "dragonfly2tpu.tenantext"

_STR = descriptor_pb2.FieldDescriptorProto.TYPE_STRING
_I32 = descriptor_pb2.FieldDescriptorProto.TYPE_INT32
_I64 = descriptor_pb2.FieldDescriptorProto.TYPE_INT64
_MSG = descriptor_pb2.FieldDescriptorProto.TYPE_MESSAGE
_OPT = descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL


def _add_field(msg, name, number, ftype, type_name=None, oneof_index=None):
    f = msg.field.add()
    f.name, f.number, f.type, f.label = name, number, ftype, _OPT
    if type_name is not None:
        f.type_name = type_name
    if oneof_index is not None:
        f.oneof_index = oneof_index
    return f


def _build():
    # A regenerated dragonfly_pb2 that already carries tenant wins.
    if "tenant" in pb.RegisterPeerRequest.DESCRIPTOR.fields_by_name:
        return (
            pb.AnnounceHostRequest,
            pb.RegisterPeerRequest,
            pb.AnnouncePeerRequest,
        )
    pool = descriptor_pool.Default()
    try:
        fd = pool.FindFileByName(_FILE)
    except KeyError:
        fdp = descriptor_pb2.FileDescriptorProto()
        fdp.name = _FILE
        fdp.package = _PKG
        fdp.syntax = "proto3"
        fdp.dependency.append("dragonfly.proto")

        reg = fdp.message_type.add()
        reg.name = "RegisterPeerRequest"
        _add_field(reg, "host_id", 1, _STR)
        _add_field(reg, "url", 2, _STR)
        _add_field(reg, "peer_id", 3, _STR)
        _add_field(reg, "task_id", 4, _STR)
        _add_field(reg, "tag", 5, _STR)
        _add_field(reg, "application", 6, _STR)
        _add_field(reg, "priority", 7, _I32)
        _add_field(reg, "tenant", 8, _STR)

        ann = fdp.message_type.add()
        ann.name = "AnnounceHostRequest"
        _add_field(ann, "host", 1, _MSG, ".dragonfly2tpu.WireHost")
        _add_field(ann, "protocol_version", 2, _I32)
        _add_field(ann, "tenant", 3, _STR)

        stream = fdp.message_type.add()
        stream.name = "AnnouncePeerRequest"
        stream.oneof_decl.add().name = "payload"
        _add_field(stream, "seq", 1, _I64)
        arms = (
            ("register", 2, f".{_PKG}.RegisterPeerRequest"),
            ("task_info", 3, ".dragonfly2tpu.SetTaskInfoRequest"),
            ("piece_finished", 4, ".dragonfly2tpu.ReportPieceFinishedRequest"),
            ("piece_failed", 5, ".dragonfly2tpu.ReportPieceFailedRequest"),
            ("peer_finished", 6, ".dragonfly2tpu.PeerRequest"),
            ("peer_failed", 7, ".dragonfly2tpu.PeerRequest"),
            ("back_to_source", 8, ".dragonfly2tpu.PeerRequest"),
            ("leave", 9, ".dragonfly2tpu.PeerRequest"),
            ("direct_piece", 10, ".dragonfly2tpu.DirectPieceRequest"),
            ("resume", 11, ".dragonfly2tpu.PeerRequest"),
        )
        for name, number, type_name in arms:
            _add_field(stream, name, number, _MSG, type_name, oneof_index=0)
        fd = pool.Add(fdp)

    def cls(name):
        desc = fd.message_types_by_name[name]
        try:
            return message_factory.GetMessageClass(desc)
        except AttributeError:  # protobuf < 4.21 spelling
            return message_factory.MessageFactory(pool).GetPrototype(desc)

    return (
        cls("AnnounceHostRequest"),
        cls("RegisterPeerRequest"),
        cls("AnnouncePeerRequest"),
    )


AnnounceHostRequest, RegisterPeerRequest, AnnouncePeerRequest = _build()
