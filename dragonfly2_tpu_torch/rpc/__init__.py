"""Wire transport (reference: pkg/rpc — the distributed communication
backend, SURVEY §5.8).

Port of the HTTP half of ``dragonfly2_tpu/rpc/``, stdlib only:

- ``scheduler_server`` / ``scheduler_client`` — HTTP/JSON control plane
  binding the real SchedulerService; the client maintains local mirrors of
  Host/Task/Peer so the daemon's Conductor runs unchanged against a remote
  scheduler.
- ``piece_transport`` — HTTP piece data plane: a threading server over the
  daemon's UploadManager (GET /pieces/<task>/<n>, Range supported) and the
  matching fetcher.
- ``daemon_control`` — the daemon's loopback control API and the
  dfget→daemon contract (state file, spawn).
- ``trainer_transport`` — the scheduler→trainer dataset stream (chunked
  HTTP uploads into TrainerService).
- ``registry_client`` / ``cluster_client`` — the manager's REST surface
  for models, scheduler registration and keepalive.
- ``balancer``  — consistent-hash ring: task-affine scheduler pick
  (pkg/balancer/consistent_hashing.go).
- ``retry``     — exponential backoff for client calls
  (pkg/rpc retry interceptors).
- ``resolver``  — the shared multi-endpoint manager address book, the
  dynconfig-fed scheduler resolver and the shard router.
- ``steering`` — the daemon's client over a scheduler list: each task's
  calls go to its owner on the consistent-hash ring.

- ``grpc_transport`` — the gRPC bindings of the same adapters
  (``SchedulerGRPCServer`` with its bidi push-reschedule stream,
  ``GRPCRemoteScheduler``, ``GRPCStreamingScheduler``, the trainer's and
  the manager's servers and clients) over ``protos/``.  It imports
  ``grpc`` and ``google.protobuf``; its names resolve lazily here, as in
  the reference, so the HTTP half imports without them.
"""

from .balancer import HashRing  # noqa: F401
from .piece_transport import (  # noqa: F401
    HTTPPieceFetcher,
    PieceConnectionPool,
    PieceHTTPServer,
)
from .registry_client import RemoteRegistry  # noqa: F401
from .retry import retry_call  # noqa: F401
from .scheduler_client import RemoteScheduler  # noqa: F401
from .scheduler_server import SchedulerHTTPServer  # noqa: F401
from .trainer_transport import RemoteTrainer, TrainerHTTPServer  # noqa: F401

_GRPC_EXPORTS = {
    "SchedulerGRPCServer", "GRPCRemoteScheduler",
    "TrainerGRPCServer", "GRPCTrainerClient",
    "ManagerGRPCServer", "GRPCRemoteRegistry",
}


def __getattr__(name: str):
    # Lazy: grpc/protobuf are only needed when a gRPC binding is used.
    if name in _GRPC_EXPORTS:
        try:
            from . import grpc_transport
        except ImportError as exc:
            raise ImportError(
                f"{__name__}.{name} needs the grpc and protobuf packages "
                f"({exc})", name=exc.name,
            ) from exc
        return getattr(grpc_transport, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
