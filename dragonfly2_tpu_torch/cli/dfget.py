"""dfget: one-shot P2P-capable download (reference: cmd/dfget + client/dfget).

Embeds the daemon + scheduler stack in-process (the reference spawns a
daemon sidecar; single-binary embedding is the library-mode equivalent),
downloads the URL piece-by-piece through the conductor — P2P when other
daemons share the process/registry, back-to-source otherwise — and
assembles the output file.

Port of ``dragonfly2_tpu/cli/dfget.py``, verbatim: ``--daemon`` goes
through the port's control API and, with ``--scheduler``, spawns the
port's ``dfdaemon``.
"""

from __future__ import annotations

import os
import sys

from ..daemon import Daemon
from ..scheduler import Evaluator, Resource, SchedulerService, Scheduling, SchedulingConfig
from ..scheduler.resource import Host
from ..source import PieceSourceFetcher
from ..utils import idgen
from .common import base_parser, init_debug, init_logging, init_tracing


def _resolve_recursive_root(url: str):
    """file:// (or bare-path) recursive source → absolute dir, or an
    error string."""
    import urllib.parse

    parsed = urllib.parse.urlsplit(url)
    if parsed.scheme not in ("", "file"):
        return None, "--recursive supports file:// sources only"
    # abspath: a relative bare path must not become a URL netloc when
    # "file://" + path is parsed back (urlsplit would eat the first
    # component as the host).
    src_root = os.path.abspath(
        urllib.parse.unquote(parsed.path) if parsed.scheme == "file" else url
    )
    if not os.path.isdir(src_root):
        return None, "--recursive needs a directory source"
    return src_root, None


def _iter_tree(src_root: str, output: str):
    """Walk the source tree: creates destination dirs (empty ones too),
    reports skipped symlinks/unreadables on stderr, yields
    (file_url, rel, dst, size) for every downloadable file."""
    import urllib.parse

    for dirpath, dirs, files in os.walk(src_root):
        # Preserve empty directories: the restored tree must be
        # structurally identical to the source.
        for d in list(dirs):
            if os.path.islink(os.path.join(dirpath, d)):
                # os.walk(followlinks=False) won't descend — an empty
                # dir here would be a silently incomplete restore.
                print(
                    f"dfget: skipped symlinked dir "
                    f"{os.path.relpath(os.path.join(dirpath, d), src_root)}",
                    file=sys.stderr,
                )
                dirs.remove(d)
                continue
            os.makedirs(
                os.path.join(output, os.path.relpath(os.path.join(dirpath, d), src_root)),
                exist_ok=True,
            )
        for name in files:
            src = os.path.join(dirpath, name)
            rel = os.path.relpath(src, src_root)
            dst = os.path.join(output, rel)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            try:
                size = os.path.getsize(src)
            except OSError as exc:
                # Dangling symlink etc: report and continue.
                print(f"dfget: skipped {rel}: {exc}", file=sys.stderr)
                continue
            # Percent-encode: '#'/'?' in filenames must survive urlsplit.
            yield "file://" + urllib.parse.quote(src), rel, dst, size


def run(argv=None) -> int:
    p = base_parser("dfget", "Download a file through the P2P stack")
    p.add_argument("url", help="source URL (file://, http://, https://)")
    p.add_argument("-O", "--output", required=True, help="output file path")
    p.add_argument("--piece-size", type=int, default=4 << 20)
    p.add_argument("--work-dir", default=None, help="piece storage dir")
    p.add_argument("--recursive", action="store_true",
                   help="download a directory tree (file:// sources)")
    p.add_argument("--daemon", action="store_true",
                   help="download through a running dfdaemon, spawning one "
                        "if absent (requires --scheduler for the spawn)")
    p.add_argument("--scheduler", default=None,
                   help="scheduler RPC URL (used when spawning a daemon)")
    args = p.parse_args(argv)
    init_logging(args, "dfget")
    init_debug(args)
    init_tracing(args)

    if args.daemon:
        # Reference path: dfget talks to a long-lived daemon, spawning it
        # when absent (cmd/dfget/cmd/root.go:234-260), so downloads share
        # one piece store + upload server across invocations.
        from ..rpc.daemon_control import (
            download_via_daemon,
            ensure_daemon,
            find_healthy_daemon,
        )

        if args.scheduler:
            try:
                daemon_url = ensure_daemon(
                    args.scheduler,
                    extra_args=["--config", args.config] if args.config else None,
                )
            except TimeoutError as exc:
                print(f"dfget: {exc}", file=sys.stderr)
                return 1
        else:
            daemon_url = find_healthy_daemon()
            if daemon_url is None:
                print(
                    "dfget: no running daemon and no --scheduler to spawn one",
                    file=sys.stderr,
                )
                return 1
        if args.recursive:
            # Directory tree through the DAEMON control API (reference:
            # rpcserver.go:407+ recursive downloads go through the
            # long-lived daemon like single files do): every file shares
            # the daemon's piece store and upload server.
            src_root, err = _resolve_recursive_root(args.url)
            if err:
                print(f"dfget: {err}", file=sys.stderr)
                return 1
            count = 0
            for url, rel, dst, _size in _iter_tree(src_root, args.output):
                result = download_via_daemon(
                    url, daemon_url, output=dst, piece_size=args.piece_size
                )
                if not result.get("ok"):
                    print(f"dfget: failed {rel}: {result}", file=sys.stderr)
                    return 1
                count += 1
            print(
                f"dfget: downloaded {count} files through daemon "
                f"-> {args.output}"
            )
            return 0
        result = download_via_daemon(
            args.url, daemon_url, output=args.output,
            piece_size=args.piece_size,
        )
        if not result.get("ok"):
            print(f"dfget: daemon download failed: {result}", file=sys.stderr)
            return 1
        mode = "back-to-source" if result.get("back_to_source") else "p2p"
        print(
            f"dfget: {result['pieces']} pieces via {mode} through daemon "
            f"in {result['cost_s']:.2f}s -> {args.output}"
        )
        return 0

    import socket
    import tempfile

    hostname = socket.gethostname()
    ip = "127.0.0.1"
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="dfget-")

    resource = Resource()
    scheduler = SchedulerService(
        resource, Scheduling(Evaluator(), SchedulingConfig(retry_interval=0))
    )
    host = Host(
        id=idgen.host_id_v2(ip, hostname), hostname=hostname, ip=ip
    )
    resource.store_host(host)
    source = PieceSourceFetcher()
    daemon = Daemon(
        host,
        scheduler,
        storage_root=os.path.join(work_dir, "storage"),
        source_fetcher=source,
    )

    if args.recursive:
        # Directory tree (reference: recursive dir download,
        # rpcserver.go:407+): each file goes through the same P2P path.
        src_root, err = _resolve_recursive_root(args.url)
        if err:
            print(f"dfget: {err}", file=sys.stderr)
            return 1
        count = 0
        for url, rel, dst, size in _iter_tree(src_root, args.output):
            result = daemon.download(
                url, piece_size=args.piece_size, content_length=size
            )
            if not result.ok:
                print(f"dfget: failed {rel}", file=sys.stderr)
                return 1
            with open(dst, "wb") as out:
                out.write(daemon.read_task_bytes(result.task_id))
            count += 1
        print(f"dfget: downloaded {count} files -> {args.output}")
        return 0

    content_length = source.content_length(args.url)
    if content_length < 0:
        print(f"dfget: cannot determine content length of {args.url}", file=sys.stderr)
        return 1

    result = daemon.download(
        args.url, piece_size=args.piece_size, content_length=content_length
    )
    if not result.ok:
        print("dfget: download failed", file=sys.stderr)
        return 1

    with open(args.output, "wb") as out:
        out.write(daemon.read_task_bytes(result.task_id))
    mode = "back-to-source" if result.back_to_source else "p2p"
    print(
        f"dfget: {content_length} bytes in {result.cost_s:.2f}s "
        f"({result.pieces} pieces, {mode}) -> {args.output}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(run())
