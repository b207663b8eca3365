"""Subprocess body for the port's mid-native-fetch SIGKILL drill
(tests/test_torch_native_fetch.py): the port's counterpart of
tests/_native_kill_child.py, importing nothing of the JAX package.

A wire daemon whose download takes the in-engine fetch path (native
store + plain-HTTP parent, DESIGN.md §28).  The parent test installs a
``crash`` FaultSpec on the ``daemon.piece.native_fetch`` seam
(DF_FAULTINJECT) positioned on a drained completion record, so the
process SIGKILLs itself BETWEEN a C++ piece commit and its Python
bookkeeping — mid-window, with the engine's workers still in flight.
The parent then proves the durable plane is untouched: a fresh
conductor over the same store resumes the download, completes, and the
reassembled bytes digest-check against the origin.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from dragonfly2_tpu_torch.utils import faultinject  # noqa: E402


def main():
    scheduler_url, store_dir, url = sys.argv[1:4]
    content_length, piece_size = int(sys.argv[4]), int(sys.argv[5])
    faultinject.install_from_env()

    from dragonfly2_tpu_torch import native
    from dragonfly2_tpu_torch.daemon import DaemonStorage
    from dragonfly2_tpu_torch.daemon.conductor import Conductor
    from dragonfly2_tpu_torch.rpc import HTTPPieceFetcher, RemoteScheduler
    from dragonfly2_tpu_torch.scheduler.resource import Host

    if not native.available():
        # The drill is native-only: make a missing library loud.
        print(json.dumps({"ok": False, "error": "native unavailable"}),
              flush=True)
        return 2

    host = Host(
        id="native-kill-child", hostname="native-kill-child", ip="127.0.0.1",
        port=8002, download_port=1,
    )
    host.stats.network.idc = "idc-a"
    client = RemoteScheduler(scheduler_url, timeout=5.0)
    storage = DaemonStorage(store_dir, prefer_native=True)
    assert storage.is_native
    conductor = Conductor(
        host, storage, client,
        piece_fetcher=HTTPPieceFetcher(client.resolve_host, timeout=5.0),
        source_fetcher=None,
        piece_parallelism=1,  # one engine worker: the kill lands early
    )
    print("native-kill-child: ready", flush=True)
    r = conductor.download(
        url, piece_size=piece_size, content_length=content_length
    )
    # Reaching here means the crash fault never fired (drill failure —
    # the parent asserts this line is absent).
    print(json.dumps({"ok": bool(r.ok), "pieces": r.pieces}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
