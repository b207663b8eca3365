"""dfcache: import/export/stat cache tasks (reference: cmd/dfcache +
client/dfcache — import/export/stat of cache tasks via the daemon).

Port of ``dragonfly2_tpu/cli/dfcache.py``, verbatim.
"""

from __future__ import annotations

import os
import sys

from ..daemon.storage import DaemonStorage
from ..utils import idgen
from .common import base_parser, init_debug, init_logging


def run(argv=None) -> int:
    p = base_parser("dfcache", "Import/export/stat local cache tasks")
    p.add_argument("command", choices=["import", "export", "stat"])
    p.add_argument("path_or_id", help="file path (import) or cache id")
    p.add_argument("-O", "--output", default=None, help="output path (export)")
    p.add_argument("--work-dir", default=os.path.expanduser("~/.dragonfly/dfcache"))
    p.add_argument("--piece-size", type=int, default=4 << 20)
    args = p.parse_args(argv)
    init_logging(args, "dfcache")
    init_debug(args)

    storage = DaemonStorage(args.work_dir)

    if args.command == "import":
        path = args.path_or_id
        size = os.path.getsize(path)
        cache_id = idgen.cache_task_id(os.path.abspath(path))
        storage.register_task(cache_id, piece_size=args.piece_size, content_length=size)
        with open(path, "rb") as f:
            n = 0
            while True:
                chunk = f.read(args.piece_size)
                if not chunk:
                    break
                storage.write_piece(cache_id, n, chunk)
                n += 1
        print(f"dfcache: imported {size} bytes as {cache_id} ({n} pieces)")
        return 0

    cache_id = args.path_or_id
    if not storage.reload_persistent_tasks([cache_id]):
        print(f"dfcache: {cache_id} not found", file=sys.stderr)
        return 1

    if args.command == "stat":
        cl = storage.engine.content_length(cache_id)
        print(
            f"dfcache: {cache_id} content_length={cl} "
            f"pieces={storage.engine.piece_count(cache_id)} bytes={storage.task_bytes(cache_id)}"
        )
        return 0

    # export
    if not args.output:
        print("dfcache: export needs -O", file=sys.stderr)
        return 1
    cl = storage.engine.content_length(cache_id)
    ps = storage.engine.piece_size(cache_id)
    with open(args.output, "wb") as out:
        remaining = cl
        n = 0
        while remaining > 0:
            piece = storage.read_piece(cache_id, n)
            out.write(piece[: min(len(piece), remaining)])
            remaining -= len(piece)
            n += 1
    print(f"dfcache: exported {cl} bytes -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(run())
