"""A peer swarm over real sockets: the port's ``dfdaemon`` builds against
the port's scheduler in serve mode, K1 ranking their parents, moving a
real file piece by piece.

``run(parse_args([...]))`` boots, in one process and under ``--out``:

- an origin: a stdlib HTTP server with ``Range`` support serving one
  file of ``--size-mib`` MiB made from ``--seed`` with numpy, counting the
  body bytes and range requests it serves;
- ``cli.scheduler.serve`` with algorithm ``ml`` and the seed-made
  32→64→64→1 scorer blob, so K1 ranks every register that has two or
  more candidates; its record storage under ``--out``;
- ``--daemons`` daemons, each ``cli.dfdaemon.build`` with the default
  ``DaemonConfig`` but its storage under ``--out``, its piece server on
  port 0 and ``--piece-kib`` pieces (default 4 MiB, the config's), each
  announced once.  At the defaults each daemon runs the native engine: the
  native piece store, ``NativePieceServer`` and the native fetch loop;
  ``--python-engine`` builds them with the Python store and server and
  ``native_fetch: false``.

Then daemon 0 downloads the file back to source; daemons 1 to N-1
download it at the same time; last, one ``cli.dfget --daemon`` download
goes through a ``DaemonControlServer`` over daemon N-1, found through
``DF_DAEMON_STATE`` under ``--out`` (the task is whole on that daemon's
disk, so the control API serves it as a reuse).  Each download sizes the
file with the source client's ``HEAD`` first, as the control API does.

The summary holds the wall time and rates, each download's result, the
origin's bytes and requests, the pieces by source and by parent host
(from the scheduler's peers), the Download records, the evaluator's
degrades and the batcher's scorer calls, and ``checks``: every output's
sha256 equals the origin's; only daemon 0 went back to source and the
origin served at most 1.25 × the file, unless the evaluator's bad-node
rule excluded daemon 0 as a parent (its verdict is in the summary as
``daemon0_bad_node``): then daemon 0 served nothing, one more daemon went
back to source and the origin served at most 1.25 × the file for each;
pieces from peers and from the source add up to daemons × pieces, the
source's equal the origin's range requests, and the peers' equal the
daemons' upload counts up to the serves that no piece is attributed to
(a hedged fetch's losing arm, a fetch that failed after its parent
served it: the summary's ``hedges_fired`` and ``failed_fetches`` bound
them); one Download record per download that registered; no evaluator
degrade; the daemons ran the engine asked for (``engine_ran``) and the
native servers leaked no thread at teardown (``no_leaked_servers``).
``engine`` reports which engine ran (``engine_report``): ``is_native``
for each daemon, the piece servers' types, the P2P pieces through the
native fetch loop and through the Python arm, the pieces and bytes each
daemon served, the bytes served by the native servers (``sendfile``) and
by the Python ones, the native servers' batched pieces, and
``native.leaked_servers()`` after teardown.  Everything the run wrote under
``--out`` is deleted at the end.

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints one JSON line.

    python -m dragonfly2_tpu_torch.bench.peer_swarm [--daemons 16] [--size-mib 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

ORIGIN_BYTES_LIMIT = 1.25  # the origin may serve at most this many copies of the file


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--daemons", type=int, default=16)
    ap.add_argument("--size-mib", type=int, default=256, help="the origin file's size")
    ap.add_argument("--piece-kib", type=int, default=4096,
                    help="the daemons' piece_size (the DaemonConfig default: 4 MiB)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for every file of the run "
                    "(default: a fresh temporary directory); deleted after")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--python-engine", action="store_true",
                    help="daemons on the Python piece store and server, native_fetch off")
    return ap.parse_args(argv)


def daemon_config(args: argparse.Namespace, store_dir: str, piece_size: int):
    """A daemon's config at the ``DaemonConfig`` defaults but for its
    storage dir, a loopback piece server on port 0, ``piece_size`` and,
    with ``--python-engine``, ``native_fetch: false``."""
    from ..config import DaemonConfig

    dc = DaemonConfig()
    dc.storage.dir = store_dir
    dc.server.host, dc.server.port = "127.0.0.1", 0
    dc.server.advertise_ip = "127.0.0.1"
    dc.piece_size = piece_size
    dc.native_fetch = not getattr(args, "python_engine", False)
    dc.validate()
    return dc


def served(node: dict) -> tuple:
    """(pieces, bytes) a ``cli.dfdaemon.build`` daemon's piece server has
    served: the native server counts in its engine, the Python one in its
    ``UploadManager``."""
    from ..rpc.piece_transport import NativePieceServer

    server = node["piece_server"]
    if isinstance(server, NativePieceServer):
        return server.upload_count, server.bytes_served
    return node["upload"].upload_count, node["upload"].bytes_served


def engine_report(nodes: list) -> dict:
    """Which engine a set of ``cli.dfdaemon.build`` daemons ran, read
    before their servers stop (``leaked_servers`` is added after)."""
    from ..rpc.piece_transport import NativePieceServer

    servers = [n["piece_server"] for n in nodes]
    native_servers = [s for s in servers if isinstance(s, NativePieceServer)]
    counts = [served(n) for n in nodes]
    return {
        "is_native": [bool(n["storage"].is_native) for n in nodes],
        "piece_servers": sorted({type(s).__name__ for s in servers}),
        "native_fetch_pieces": sum(n["conductor"].native_pieces for n in nodes),
        "served_pieces": [c[0] for c in counts],
        "served_bytes": [c[1] for c in counts],
        "sendfile_bytes": sum(s.bytes_served for s in native_servers),
        "python_served_bytes": sum(c[1] for n, c in zip(nodes, counts)
                                   if not isinstance(n["piece_server"], NativePieceServer)),
        "batched_pieces": sum(s.batched_pieces for s in native_servers),
    }


def engine_ran(engine: dict, native: bool) -> bool:
    """Every daemon ran the engine asked for: with ``native`` the native
    store and ``NativePieceServer`` and more than 0 pieces through the
    fetch loop, else the Python store and server and none."""
    if native:
        return (all(engine["is_native"]) and engine["piece_servers"] == ["NativePieceServer"]
                and engine["native_fetch_pieces"] > 0)
    return (not any(engine["is_native"]) and engine["piece_servers"] == ["PieceHTTPServer"]
            and engine["native_fetch_pieces"] == 0)


def finish_engine(summary: dict) -> None:
    """After teardown: ``native.leaked_servers()`` into ``engine`` and the
    ``no_leaked_servers`` check (a native server whose stop timed out
    leaks its struct and counts here)."""
    from .. import native

    leaked = list(native.leaked_servers())
    summary["engine"]["leaked_servers"] = leaked
    summary["checks"]["no_leaked_servers"] = leaked == [0, 0]


class Origin:
    """A stdlib HTTP origin for one file (``path``), answered at any path
    (``url`` is ``/blob.bin``), or for files by name (``path`` a dict
    name → file), each at ``/<name>.bin`` (``url_of``; another path
    answers 404): ``HEAD`` answers the length, ``GET`` with ``Range:
    bytes=a-b`` answers 206 with the span.  With ``delay`` (lo, hi) every
    request first sleeps a time drawn from that span with ``seed``.
    Counts the body bytes and the GETs it served."""

    def __init__(self, path, *, delay=None, seed: int = 0) -> None:
        self.paths = dict(path) if isinstance(path, dict) else {"blob": path}
        self.sizes = {k: os.path.getsize(p) for k, p in self.paths.items()}
        self.bytes_served = 0
        self.requests = 0
        mu = threading.Lock()
        rng = random.Random(seed)
        single = not isinstance(path, dict)
        origin = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _file(self):
                """The name of the file asked for, after the delay; None
                once a 404 has answered."""
                if delay is not None:
                    with mu:
                        wait = rng.uniform(*delay)
                    time.sleep(wait)
                name = "blob" if single else self.path.strip("/").removesuffix(".bin")
                if name in origin.sizes:
                    return name
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return None

            def do_HEAD(self):
                name = self._file()
                if name is None:
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(origin.sizes[name]))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                name = self._file()
                if name is None:
                    return
                size = origin.sizes[name]
                start, end = 0, size - 1
                spec = self.headers.get("Range", "")
                if spec.startswith("bytes="):
                    a, _, b = spec[len("bytes="):].partition("-")
                    start = int(a)
                    end = min(int(b), size - 1) if b else size - 1
                if start > end:
                    self.send_response(416)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                with open(origin.paths[name], "rb") as f:
                    f.seek(start)
                    body = f.read(end - start + 1)
                self.send_response(206 if spec else 200)
                self.send_header("Content-Length", str(len(body)))
                if spec:
                    self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
                self.end_headers()
                self.wfile.write(body)
                with mu:
                    origin.bytes_served += len(body)
                    origin.requests += 1

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.base = f"http://127.0.0.1:{self._server.server_address[1]}"
        self.url = self.url_of("blob")
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="origin", daemon=True)

    def url_of(self, name: str) -> str:
        return f"{self.base}/{name}.bin"

    def serve(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _make_file(path: str, size: int, seed: int) -> str:
    """Write ``size`` seed-made bytes to ``path``; → their sha256."""
    data = np.random.default_rng(seed).bytes(size)
    with open(path, "wb") as f:
        f.write(data)
    return hashlib.sha256(data).hexdigest()


def _task_sha256(storage, task_id: str) -> str:
    """sha256 of a task's content, piece by piece (each read crc-checked)."""
    h = hashlib.sha256()
    remaining = storage.content_length(task_id)
    n = 0
    while remaining > 0:
        piece = storage.read_piece(task_id, n)
        h.update(piece[:remaining])
        remaining -= len(piece)
        n += 1
    return h.hexdigest()


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(8 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _pieces_by_parent(service, task_id: str, host_names: dict) -> dict:
    """Pieces the scheduler's peers of the task report, by where each came
    from: ``source`` or the parent's daemon."""
    out: dict = {}
    for peer in service.resource.peer_manager.items():
        if peer.task.id != task_id:
            continue
        for piece in list(peer.pieces.values()):
            if not piece.parent_id:
                key = "source"
            else:
                parent = service.resource.peer_manager.load(piece.parent_id)
                key = host_names.get(parent.host.id, parent.host.id) if parent else "unknown"
            out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def run(args: argparse.Namespace, *, log=print) -> dict:
    from ..cli import dfdaemon, dfget
    from ..daemon.piece_pipeline import PIECE_HEDGE_TOTAL
    from ..cli import scheduler as scheduler_cli
    from ..config import SchedulerConfigFile
    from ..rpc.daemon_control import STATE_ENV, DaemonControlServer, write_state
    from .wire_loop import seeded_k1_blob

    out_dir = args.out or tempfile.mkdtemp(prefix="peer_swarm-")
    work = os.path.join(out_dir, "peer_swarm")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    size = args.size_mib << 20
    piece_size = args.piece_kib << 10
    n_pieces = (size + piece_size - 1) // piece_size
    origin = serving = control = summary = None
    nodes = []
    saved_state = os.environ.get(STATE_ENV)
    try:
        t_setup = time.perf_counter()
        origin_sha = _make_file(os.path.join(work, "blob.bin"), size, args.seed)
        origin = Origin(os.path.join(work, "blob.bin"))
        origin.serve()

        cfg = SchedulerConfigFile()
        cfg.server.host, cfg.server.port = "127.0.0.1", 0
        cfg.storage.dir = os.path.join(work, "records")
        cfg.scheduling.algorithm = "ml"
        # As the other serving phases: a cold task's first register goes
        # back to source without sleeping out the retry loop.
        cfg.scheduling.retry_interval_s = 0.0
        serving = scheduler_cli.serve(cfg, device=args.device,
                                      scorer_blob=seeded_k1_blob(args.seed),
                                      rng=random.Random(args.seed))
        service = serving.service
        ev = service.scheduling.evaluator
        native = not args.python_engine
        for i in range(args.daemons):
            dc = daemon_config(args, os.path.join(work, f"daemon{i}"), piece_size)
            nodes.append(dfdaemon.build(dc, serving.url, prefer_native=native))
        for n in nodes:
            n["announcer"].announce_once()
        host_names = {n["host"].id: f"daemon{i}" for i, n in enumerate(nodes)}
        setup_s = time.perf_counter() - t_setup
        calls0 = ev.batcher.scorer_calls
        hedges0 = PIECE_HEDGE_TOTAL.value(outcome="fired")
        log(f"peer_swarm: {args.daemons} daemons, {size} bytes in {n_pieces} pieces, "
            f"scheduler {serving.url}, origin {origin.url} ({setup_s:.1f}s setup)")

        results: list = [None] * args.daemons

        def download(i: int) -> None:
            conductor = nodes[i]["conductor"]
            length = conductor.probe_content_length(origin.url)
            results[i] = conductor.download(origin.url, piece_size=piece_size,
                                            content_length=length)

        t0 = time.perf_counter()
        download(0)
        t_first = time.perf_counter()
        # The evaluator's verdict on daemon 0 as a parent when the others
        # register (its costs change only once it serves).
        peer0 = service.resource.peer_manager.load(results[0].peer_id) if results[0] else None
        parent0_bad = bool(peer0 is not None and ev.is_bad_node(peer0))
        threads = [threading.Thread(target=download, args=(i,), name=f"daemon{i}-dl",
                                    daemon=True) for i in range(1, args.daemons)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        t_swarm = time.perf_counter()
        scorer_calls = ev.batcher.scorer_calls - calls0

        # dfget --daemon through the last daemon's control API.
        control = DaemonControlServer(nodes[-1]["conductor"], piece_size=piece_size)
        control.serve()
        os.environ[STATE_ENV] = os.path.join(work, "daemon.json")
        write_state(control.url)
        dfget_out = os.path.join(work, "dfget.bin")
        t_dfget = time.perf_counter()
        dfget_rc = dfget.run([origin.url, "-O", dfget_out, "--daemon",
                              "--piece-size", str(piece_size)])
        dfget_s = time.perf_counter() - t_dfget

        ok = [r is not None and r.ok for r in results]
        task_id = results[0].task_id if results[0] is not None else ""
        shas = [_task_sha256(n["storage"], r.task_id) if r is not None and r.ok else ""
                for n, r in zip(nodes, results)]
        dfget_sha = _file_sha256(dfget_out) if dfget_rc == 0 else ""
        service.storage.flush()
        by_parent = _pieces_by_parent(service, task_id, host_names)
        p2p_pieces = sum(v for k, v in by_parent.items() if k != "source")
        # A piece server accounts a serve after it has written the body, so
        # its count may trail the client that already holds the piece.
        deadline = time.monotonic() + 10.0
        while (sum(served(n)[0] for n in nodes) < p2p_pieces
               and time.monotonic() < deadline):
            time.sleep(0.01)
        engine = engine_report(nodes)
        uploads = engine["served_pieces"]
        # A hedged fetch's losing arm and a fetch that failed after its
        # parent served the body are serves no piece is attributed to.
        hedges = PIECE_HEDGE_TOTAL.value(outcome="fired") - hedges0
        failed = sum(r.failed_pieces for r in results if r is not None)
        costs = [r.cost_s for r in results if r is not None]
        p2p_rates = [size / r.cost_s / 1e6 for r in results[1:] if r is not None and r.ok]
        swarm_s = t_swarm - t0
        summary = {
            "daemons": args.daemons, "bytes": size, "piece_size": piece_size,
            "pieces": n_pieces, "setup_seconds": setup_s,
            "wall_seconds": swarm_s, "first_seconds": t_first - t0,
            "concurrent_seconds": t_swarm - t_first,
            "aggregate_mb_s": args.daemons * size / swarm_s / 1e6,
            "daemon_mb_s": [size / r.cost_s / 1e6 if r is not None and r.ok else 0.0
                            for r in results],
            "daemon0_p2p_share": by_parent.get("daemon0", 0) / max(p2p_pieces, 1),
            "source_mb_s": size / results[0].cost_s / 1e6 if ok[0] else 0.0,
            "p2p_mb_s": {"p50": float(np.percentile(p2p_rates, 50)) if p2p_rates else 0.0,
                         "p99": float(np.percentile(p2p_rates, 99)) if p2p_rates else 0.0,
                         "min": min(p2p_rates, default=0.0)},
            "download_seconds": costs,
            "back_to_source": [bool(r.back_to_source) if r is not None else None
                               for r in results],
            "origin": {"bytes": origin.bytes_served, "requests": origin.requests,
                       "limit_bytes": ORIGIN_BYTES_LIMIT * size},
            "pieces_by_parent": by_parent, "uploads": uploads,
            "hedges_fired": hedges, "failed_fetches": failed, "daemon0_bad_node": parent0_bad,
            "download_records": service.storage.download_count,
            "rule_degrades": ev.degrades, "scorer_calls": scorer_calls,
            "batcher_fallbacks": ev.batcher.fallbacks,
            "dfget": {"rc": dfget_rc, "seconds": dfget_s},
            "engine": engine,
        }
        # Daemon 0 seeds the swarm unless the evaluator's bad-node rule
        # (its last piece cost past 3 sigma of the others, evaluator.go:
        # 92-129) excludes it as a parent: then it serves nothing and the
        # first daemon to register goes back to source in its place.
        sources = 2 if parent0_bad else 1
        seeded_by = [True] * sources + [False] * (args.daemons - sources)
        summary["checks"] = {
            "all_downloads_ok": all(ok) and dfget_rc == 0,
            "sha256_equal": all(s == origin_sha for s in shas) and dfget_sha == origin_sha,
            "only_daemon0_back_to_source": sorted(summary["back_to_source"], reverse=True)
            == seeded_by and summary["back_to_source"][0]
            and (not parent0_bad or uploads[0] == 0),
            "origin_bytes_within_limit":
            origin.bytes_served <= ORIGIN_BYTES_LIMIT * size * sources,
            "pieces_add_up": sum(by_parent.values()) == args.daemons * n_pieces
            and p2p_pieces <= sum(uploads) <= p2p_pieces + hedges + failed
            and by_parent.get("source", 0) == origin.requests,
            "one_record_per_download": service.storage.download_count == args.daemons,
            "no_degrade": ev.degrades == 0 and ev.batcher.fallbacks == 0,
            "engine_ran": engine_ran(engine, native),
        }
    finally:
        if control is not None:
            control.stop()
        for n in nodes:
            n["announcer"].stop()
            n["piece_server"].stop()
        if serving is not None:
            serving.stop()
        if origin is not None:
            origin.stop()
        if saved_state is None:
            os.environ.pop(STATE_ENV, None)
        else:
            os.environ[STATE_ENV] = saved_state
        shutil.rmtree(work, ignore_errors=True)
        if not args.out:
            shutil.rmtree(out_dir, ignore_errors=True)
    finish_engine(summary)
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("peer_swarm: no CUDA device", file=sys.stderr)
            return 2
    summary = run(args, log=lambda line: print(line, file=sys.stderr))
    print(json.dumps(summary))
    return 0 if all(summary["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
