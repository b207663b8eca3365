"""Test helper: make ``grpc`` unimportable for the port, in process, as on
a machine without the package."""

from __future__ import annotations

import sys


def block_grpc(monkeypatch) -> None:
    """Until ``monkeypatch`` undoes it: ``import grpc`` fails, and the
    port's ``rpc.grpc_transport`` must be imported anew (so it fails too)."""
    import dragonfly2_tpu_torch.rpc as rpc

    monkeypatch.setitem(sys.modules, "grpc", None)
    for name in ("dragonfly2_tpu_torch.rpc.grpc_transport",
                 "dragonfly2_tpu_torch.rpc.ratelimit_grpc"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.delattr(rpc, "grpc_transport", raising=False)
    monkeypatch.delattr(rpc, "ratelimit_grpc", raising=False)
