"""A node pool pulling one image through the daemons' registry proxies,
then reading objects through their object gateways: the port's
``dfdaemon`` builds against the port's scheduler in serve mode, K1
ranking the parents of every diverted layer and every gateway read.

``run(parse_args([...]))`` boots, in one process and under ``--out``:

- an in-process registry (the origin) serving one image: the manifest
  ``/v2/library/app/manifests/latest`` and one blob a layer,
  ``/v2/library/app/blobs/sha256:<digest>``, of ``--layers-mib`` MiB
  each, made from ``--seed`` with numpy; ``HEAD`` answers a length,
  ``GET`` takes ``Range``; every request is answered after 20-25 ms, as a
  remote registry answers, and the layer bytes it serves are counted;
- ``cli.scheduler.serve`` with algorithm ``ml`` and the seed-made
  32→64→64→1 scorer blob (K1); its record storage under ``--out``;
- ``--daemons`` daemons, each ``cli.dfdaemon.build`` at the
  ``DaemonConfig`` defaults (the native engine) but for its storage under
  ``--out``, a loopback piece server on port 0 and ``--piece-kib``
  pieces; each announced once.  Each daemon's source chain also reads
  ``dfstore://`` URLs from the object backend (the gateway's
  back-to-source), and counts the bytes it fetches back to source;
- in front of each daemon a ``daemon/proxy.P2PProxy`` whose one rule
  diverts ``blobs/sha256.*`` into P2P (the default rule of upstream
  Dragonfly's documented ``dfdaemon.yaml``), and an
  ``daemon/gateway.ObjectGateway`` over one ``FilesystemBackend`` bucket.

(a) The pull: one client a daemon, all started together, GETs the
manifest through its proxy (direct: no rule matches) and then each layer
in order (P2P), checking each layer's sha256 against its digest and
timing its first byte; on the last layer each client also notes whether
the daemon's task was still running when its first byte arrived.  Then
one ``Range`` request a layer (206, the exact bytes), one unsatisfiable
``Range`` (416), one ``CONNECT`` to the registry's port with the
manifest fetched through the tunnel, and one ``CONNECT`` to a closed port
(502).

(b) The gateway: daemon 0 puts ``--objects`` objects of ``--object-mib``
MiB made from the seed; daemons 1 to N-1 get them all, at the same time.

The summary holds the wall times and rates, the layer first-byte p50 and
p99, the proxies' stats summed, the origin's layer bytes against the
back-to-source bytes the daemons fetched (and their ratio to the image),
the pieces by parent (from the scheduler's peers), daemon 0's share of
P2P pieces, the batcher's scorer calls, and ``checks``.  Everything the
run wrote under ``--out`` is deleted at the end.

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints one JSON line.

    python -m dragonfly2_tpu_torch.bench.registry_proxy [--daemons 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import random
import shutil
import socket
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .peer_swarm import daemon_config, engine_report, finish_engine, served

REPO_PATH = "/v2/library/app"
MANIFEST_PATH = f"{REPO_PATH}/manifests/latest"
BLOB_RULE = r"blobs/sha256.*"
ORIGIN_DELAY_S = (0.020, 0.025)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--daemons", type=int, default=16)
    ap.add_argument("--layers-mib", default="1,2,4,8,16,32,64,129",
                    help="the image's layer sizes in MiB, comma-separated")
    ap.add_argument("--objects", type=int, default=32)
    ap.add_argument("--object-mib", type=float, default=4.0)
    ap.add_argument("--piece-kib", type=int, default=4096,
                    help="the daemons' piece_size (the DaemonConfig default: 4 MiB)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for every file of the run "
                    "(default: a fresh temporary directory); deleted after")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Registry:
    """The origin: a stdlib HTTP registry for one image, answering each
    request after 20-25 ms.  Counts the layer body bytes and requests."""

    def __init__(self, layers: list, seed: int) -> None:
        self.blobs = {f"{REPO_PATH}/blobs/sha256:{hashlib.sha256(b).hexdigest()}": b
                      for b in layers}
        self.manifest = json.dumps({
            "schemaVersion": 2,
            "mediaType": "application/vnd.oci.image.manifest.v1+json",
            "layers": [{"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                        "digest": path.rsplit("/", 1)[1], "size": len(b)}
                       for path, b in self.blobs.items()],
        }).encode()
        self.layer_bytes = 0
        self.layer_requests = 0
        self.manifest_requests = 0
        mu = threading.Lock()
        rng = random.Random(seed)
        origin = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _body(self):
                if self.path == MANIFEST_PATH:
                    return origin.manifest
                return origin.blobs.get(self.path)

            def _delay(self):
                with mu:
                    d = rng.uniform(*ORIGIN_DELAY_S)
                time.sleep(d)

            def do_HEAD(self):
                self._delay()
                body = self._body()
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):
                self._delay()
                body = self._body()
                if body is None:
                    self.send_error(404)
                    return
                start, end = 0, len(body) - 1
                spec = self.headers.get("Range", "")
                if spec.startswith("bytes="):
                    a, _, b = spec[len("bytes="):].partition("-")
                    start = int(a)
                    end = min(int(b), len(body) - 1) if b else len(body) - 1
                chunk = body[start:end + 1]
                self.send_response(206 if spec else 200)
                self.send_header("Content-Length", str(len(chunk)))
                if spec:
                    self.send_header("Content-Range", f"bytes {start}-{end}/{len(body)}")
                self.end_headers()
                self.wfile.write(chunk)
                with mu:
                    if body is origin.manifest:
                        origin.manifest_requests += 1
                    else:
                        origin.layer_bytes += len(chunk)
                        origin.layer_requests += 1

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="registry", daemon=True)

    def serve(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class ObjectSource:
    """A ``source`` client for ``dfstore://BUCKET/KEY`` URLs over an object
    backend (the gateway's back-to-source, ``GatewaySourceFetcher``'s
    reads by range)."""

    def __init__(self, backend) -> None:
        self.backend = backend

    @staticmethod
    def _split(url: str):
        bucket, key = url[len("dfstore://"):].split("/", 1)
        return bucket, key

    def content_length(self, url: str) -> int:
        return self.backend.head_object(*self._split(url)).content_length

    def read_range(self, url: str, start: int, length: int) -> bytes:
        return self.backend.get_object(*self._split(url))[start:start + length]


class CountingSource:
    """A daemon's back-to-source chain, counting the bytes it fetches by
    scheme."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.bytes = {}
        self._mu = threading.Lock()

    def content_length(self, url: str, headers=None) -> int:
        return self.inner.content_length(url, headers=headers)

    def fetch(self, url: str, number: int, piece_size: int, headers=None) -> bytes:
        data = self.inner.fetch(url, number, piece_size, headers=headers)
        scheme = url.split("://", 1)[0]
        with self._mu:
            self.bytes[scheme] = self.bytes.get(scheme, 0) + len(data)
        return data


def _percentile(xs, q):
    return float(np.percentile(xs, q)) if xs else 0.0


def _pull(proxy_port: int, url: str, *, on_first=None, headers=None):
    """GET ``url`` (absolute form) through a proxy → (status, headers,
    sha256 of the body, body bytes, seconds to the first body byte)."""
    conn = http.client.HTTPConnection("127.0.0.1", proxy_port, timeout=120)
    t0 = time.perf_counter()
    try:
        conn.request("GET", url, headers=headers or {})
        resp = conn.getresponse()
        h = hashlib.sha256()
        n = 0
        first_s = None
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            if first_s is None:
                first_s = time.perf_counter() - t0
                if on_first is not None:
                    on_first()
            h.update(chunk)
            n += len(chunk)
        return resp.status, dict(resp.getheaders()), h.hexdigest(), n, first_s
    finally:
        conn.close()


def _connect_status(proxy_port: int, port: int) -> str:
    with socket.create_connection(("127.0.0.1", proxy_port), timeout=30) as sock:
        sock.sendall(f"CONNECT 127.0.0.1:{port} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        return sock.makefile("rb").readline().decode().strip()


def _task_pieces(service, task_ids: set, host_names: dict) -> dict:
    """Pieces of ``task_ids`` by where they came from (``source`` or the
    parent's daemon), from the scheduler's peers."""
    out: dict = {}
    for peer in service.resource.peer_manager.items():
        if peer.task.id not in task_ids:
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
    from ..cli import dfdaemon
    from ..cli import scheduler as scheduler_cli
    from ..config import SchedulerConfigFile
    from ..daemon.gateway import GatewayConfig, ObjectGateway
    from ..daemon.proxy import P2PProxy, ProxyRouter, ProxyRule
    from ..objectstorage import FilesystemBackend
    from ..source.client import PieceSourceFetcher, SourceRegistry, default_registry
    from ..utils import idgen
    from .wire_loop import seeded_k1_blob

    out_dir = args.out or tempfile.mkdtemp(prefix="registry_proxy-")
    work = os.path.join(out_dir, "registry_proxy")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    piece_size = args.piece_kib << 10
    sizes = [int(float(m) * (1 << 20)) for m in args.layers_mib.split(",")]
    rng = np.random.default_rng(args.seed)
    layers = [rng.bytes(s) for s in sizes]
    image_bytes = sum(sizes)
    obj_size = int(args.object_mib * (1 << 20))
    objects = [rng.bytes(obj_size) for _ in range(args.objects)]
    registry = serving = summary = None
    nodes, proxies = [], []
    try:
        t_setup = time.perf_counter()
        registry = Registry(layers, args.seed)
        registry.serve()
        layer_urls = [registry.base + path for path in registry.blobs]
        digests = [u.rsplit("sha256:", 1)[1] for u in layer_urls]

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
        backend = FilesystemBackend(os.path.join(work, "objects"))
        sources = SourceRegistry()
        for scheme in ("file", "", "http", "https"):
            sources.register(scheme, default_registry.client_for(f"{scheme}://x"
                                                                 if scheme else "x"))
        sources.register("dfstore", ObjectSource(backend))
        router = ProxyRouter([ProxyRule.compile(BLOB_RULE)])
        counters, gateways = [], []
        for i in range(args.daemons):
            dc = daemon_config(args, os.path.join(work, f"daemon{i}"), piece_size)
            parts = dfdaemon.build(dc, serving.url)
            counters.append(CountingSource(PieceSourceFetcher(sources)))
            parts["conductor"].source_fetcher = counters[-1]
            nodes.append(parts)
            daemon = parts["daemon"]
            proxy = P2PProxy(daemon, router, piece_size=piece_size)
            proxy.serve()
            proxies.append(proxy)
            gateways.append(ObjectGateway(daemon, backend, GatewayConfig(piece_size=piece_size)))
        for n in nodes:
            n["announcer"].announce_once()
        host_names = {n["host"].id: f"daemon{i}" for i, n in enumerate(nodes)}
        setup_s = time.perf_counter() - t_setup
        calls0 = ev.batcher.scorer_calls
        log(f"registry_proxy: {args.daemons} daemons, {len(sizes)} layers of "
            f"{image_bytes} bytes, scheduler {serving.url}, registry {registry.base} "
            f"({setup_s:.1f}s setup)")

        # -- (a) the pull ----------------------------------------------------
        pulls: list = [None] * args.daemons
        last_tid = idgen.task_id(layer_urls[-1])
        start = threading.Barrier(args.daemons)

        def client(i: int) -> None:
            port = proxies[i].port
            out = {"layers": [], "manifest": None, "last_first_before_done": None}
            start.wait()
            status, _, sha, n, _ = _pull(port, registry.base + MANIFEST_PATH)
            out["manifest"] = (status, sha == hashlib.sha256(registry.manifest).hexdigest())
            for j, url in enumerate(layer_urls):
                seen = {}

                def on_first(j=j, seen=seen):
                    if j == len(layer_urls) - 1:
                        seen["running"] = nodes[i]["conductor"].active_run(last_tid) is not None

                status, _, sha, n, first_s = _pull(port, url, on_first=on_first)
                out["layers"].append({"status": status, "sha_ok": sha == digests[j],
                                      "bytes": n, "first_byte_s": first_s})
                if "running" in seen:
                    out["last_first_before_done"] = seen["running"]
            pulls[i] = out

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,), name=f"puller{i}", daemon=True)
                   for i in range(args.daemons)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        pull_s = time.perf_counter() - t0
        pull_calls = ev.batcher.scorer_calls - calls0

        # The single requests, through daemon 0's proxy.
        port0 = proxies[0].port
        ranges = []
        for j, (url, body) in enumerate(zip(layer_urls, layers)):
            a = int(rng.integers(0, len(body)))
            b = int(rng.integers(a, len(body)))
            status, headers, sha, n, _ = _pull(port0, url, headers={"Range": f"bytes={a}-{b}"})
            ranges.append({"status": status, "bytes": n,
                           "exact": sha == hashlib.sha256(body[a:b + 1]).hexdigest()
                           and headers.get("Content-Range") == f"bytes {a}-{b}/{len(body)}"})
        bad_status, bad_headers, _, _, _ = _pull(
            port0, layer_urls[0], headers={"Range": f"bytes={sizes[0] + 7}-"})
        tunnel = http.client.HTTPConnection("127.0.0.1", port0, timeout=30)
        tunnel.set_tunnel("127.0.0.1", registry.port)
        tunnel.request("GET", MANIFEST_PATH)
        tunnel_resp = tunnel.getresponse()
        tunnel_ok = tunnel_resp.status == 200 and tunnel_resp.read() == registry.manifest
        tunnel.close()
        closed = socket.socket()
        closed.bind(("127.0.0.1", 0))
        closed_port = closed.getsockname()[1]
        closed.close()
        bad_connect = _connect_status(port0, closed_port)
        singles_s = time.perf_counter() - t0 - pull_s

        # -- (b) the gateway -------------------------------------------------
        keys = [f"models/object-{k:03d}.bin" for k in range(args.objects)]
        t_put = time.perf_counter()
        for key, body in zip(keys, objects):
            gateways[0].put_object(key, body)
        put_s = time.perf_counter() - t_put
        src_before = [dict(c.bytes) for c in counters]
        gets: list = [None] * args.daemons

        def reader(i: int) -> None:
            gets[i] = [hashlib.sha256(gateways[i].get_object(k)).hexdigest()
                       == hashlib.sha256(b).hexdigest() for k, b in zip(keys, objects)]

        t_get = time.perf_counter()
        readers = [threading.Thread(target=reader, args=(i,), name=f"reader{i}", daemon=True)
                   for i in range(1, args.daemons)]
        for th in readers:
            th.start()
        for th in readers:
            th.join()
        get_s = time.perf_counter() - t_get
        gateway_source = [c.bytes.get("dfstore", 0) - before.get("dfstore", 0)
                          for c, before in zip(counters, src_before)]
        scorer_calls = ev.batcher.scorer_calls - calls0

        # -- accounting ------------------------------------------------------
        layer_tids = {idgen.task_id(u) for u in layer_urls}
        object_tids = {gateways[0]._task_id(k) for k in keys}
        layer_pieces = _task_pieces(service, layer_tids, host_names)
        object_pieces = _task_pieces(service, object_tids, host_names)
        p2p_layer = sum(v for k, v in layer_pieces.items() if k != "source")
        source_http = sum(c.bytes.get("http", 0) for c in counters)
        stats = {k: sum(p.stats[k] for p in proxies) for k in ("p2p", "direct", "tunnel")}
        firsts = [x["first_byte_s"] for p in pulls if p for x in p["layers"]
                  if x["first_byte_s"] is not None]
        engine = engine_report(nodes)
        summary = {
            "daemons": args.daemons, "layers": len(sizes), "layer_bytes": sizes,
            "image_bytes": image_bytes, "piece_size": piece_size,
            "setup_seconds": setup_s, "pull_seconds": pull_s, "singles_seconds": singles_s,
            "aggregate_mb_s": args.daemons * image_bytes / pull_s / 1e6,
            "layer_first_byte_s": {"p50": _percentile(firsts, 50), "p99": _percentile(firsts, 99),
                                   "max": max(firsts, default=0.0)},
            "proxy_stats": stats,
            "origin": {"layer_bytes": registry.layer_bytes,
                       "layer_requests": registry.layer_requests,
                       "manifest_requests": registry.manifest_requests,
                       "image_ratio": registry.layer_bytes / image_bytes},
            "back_to_source_bytes": {"http": source_http, "dfstore": sum(
                c.bytes.get("dfstore", 0) for c in counters)},
            "layer_pieces_by_parent": layer_pieces,
            "daemon0_p2p_share": layer_pieces.get("daemon0", 0) / max(p2p_layer, 1),
            "last_layer_first_byte_before_done": [p["last_first_before_done"] for p in pulls
                                                  if p],
            "ranges": ranges, "unsatisfiable": {"status": bad_status,
                                                "content_range": bad_headers.get(
                                                    "Content-Range", "")},
            "tunnel_ok": tunnel_ok, "bad_connect": bad_connect,
            "gateway": {"objects": args.objects, "object_bytes": obj_size,
                        "put_seconds": put_s, "get_seconds": get_s,
                        "get_mb_s": (args.daemons - 1) * args.objects * obj_size / get_s / 1e6,
                        "source_bytes_by_daemon": gateway_source,
                        "object_pieces_by_parent": object_pieces,
                        "daemon0_uploads": served(nodes[0])[0]},
            "scorer_calls": scorer_calls, "pull_scorer_calls": pull_calls,
            "rule_degrades": ev.degrades, "batcher_fallbacks": ev.batcher.fallbacks,
            "engine": engine,
        }
        n_pulls = args.daemons * len(sizes)
        summary["checks"] = {
            "manifests_direct": all(p and p["manifest"] == (200, True) for p in pulls),
            "layers_sha256_equal": all(p and all(x["status"] == 200 and x["sha_ok"]
                                                 for x in p["layers"]) for p in pulls),
            "ranges_exact": all(r["status"] == 206 and r["exact"] for r in ranges),
            "unsatisfiable_416": bad_status == 416
            and bad_headers.get("Content-Range") == f"bytes */{sizes[0]}",
            "tunnel_passes_bytes": tunnel_ok,
            "bad_connect_502": " 502 " in f"{bad_connect} ",
            "proxy_stats": stats == {"p2p": n_pulls + len(sizes), "direct": args.daemons,
                                     "tunnel": 1},
            "origin_bytes_equal_back_to_source": registry.layer_bytes == source_http > 0,
            "objects_sha256_equal": all(all(g) for g in gets[1:]) and len(gets[1:]) > 0,
            "gets_from_the_swarm": summary["gateway"]["daemon0_uploads"] > 0
            and not any(gateway_source[1:]),
            "first_byte_before_task_done": any(summary["last_layer_first_byte_before_done"]),
            "no_degrade": ev.degrades == 0 and ev.batcher.fallbacks == 0,
            # Every daemon on the native store and server.  A streamed task
            # drains through the Python arm (the commit tee needs verified
            # bodies in Python, the reference's routing), so the fetch loop
            # may land none of these pieces.
            "engine_ran": all(engine["is_native"])
            and engine["piece_servers"] == ["NativePieceServer"],
        }
    finally:
        for p in proxies:
            p.stop()
        for n in nodes:
            n["announcer"].stop()
            n["piece_server"].stop()
        if serving is not None:
            serving.stop()
        if registry is not None:
            registry.stop()
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
            print("registry_proxy: no CUDA device", file=sys.stderr)
            return 2
    summary = run(args, log=lambda line: print(line, file=sys.stderr))
    print(json.dumps(summary))
    return 0 if all(summary["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
