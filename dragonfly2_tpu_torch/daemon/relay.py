"""Half-close-correct byte relay shared by the CONNECT tunnel and the
SNI pass-through (client/daemon/proxy's tunnel path).

EOF on one side shuts only the OTHER side's write half; data keeps
flowing the remaining direction until both halves close or the idle
budget expires.

Port of ``dragonfly2_tpu/daemon/relay.py``, verbatim but for the wait:
``relay_bytes`` waits on a ``selectors`` selector (epoll on Linux) where
the reference calls ``select.select``, which refuses any descriptor at
or past ``FD_SETSIZE`` (1,024): in a long-lived daemon process holding
that many files and sockets, every CONNECT tunnel failed.
"""

from __future__ import annotations

import selectors
import socket


def relay_bytes(a: socket.socket, b: socket.socket, idle_timeout: float) -> None:
    from ..utils import faultinject

    open_dirs = {a: b, b: a}
    with selectors.DefaultSelector() as sel:
        for sock in open_dirs:
            sel.register(sock, selectors.EVENT_READ)
        while open_dirs:
            ready = sel.select(idle_timeout)
            if not ready:
                return  # idle past the budget
            for key, _ in ready:
                sock = key.fileobj
                dst = open_dirs.get(sock)
                if dst is None:
                    continue
                try:
                    # Drop/truncate here = mid-tunnel reset/torn pump: the
                    # half-close teardown below must run, not leak the pair.
                    data = faultinject.fire("relay.pump", sock.recv(65536))
                except OSError:
                    data = b""
                if not data:
                    try:
                        dst.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    del open_dirs[sock]
                    sel.unregister(sock)
                else:
                    dst.sendall(data)


def fetch_via_p2p(daemon, url: str, piece_size: int) -> bytes:
    """Route one URL through the daemon's P2P engine and return the bytes
    (transport.go's divert seam, shared by both proxy faces)."""
    result = daemon.download(
        url, piece_size=piece_size,
        content_length=daemon.conductor.probe_content_length(url),
    )
    if not result.ok:
        raise IOError(f"p2p download of {url} failed")
    return daemon.read_task_bytes(result.task_id)
