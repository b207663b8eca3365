"""A secured cluster: the manager as the cluster CA with users and
personal access tokens, a scheduler and daemons that boot by requesting
their identities and then announce over mutual TLS on the scheduler's
gRPC port and move pieces over mutual TLS, and HTTPS image pulls
intercepted by the daemons' SNI proxies — K1 ranking the parents of
every download and every hijacked pull.

``run(parse_args([...]))`` boots, in one process and under ``--out``:

- ``cli.manager.serve`` with ``ca_dir`` (the persistent cluster CA),
  a 32-byte ``token_secret``, ``users_db`` and ``root_password``; root
  signs in over REST and mints two personal access tokens, a PEER one
  for the scheduler and the daemons and an OPERATOR one for the bench;
- ``cli.scheduler.serve`` with algorithm ``ml`` over the seed-made
  32→64→64→1 scorer blob (K1), ``security.auto_issue`` with the PEER
  token as ``manager_token``, ``server.grpc_port`` 0 and
  ``advertise_ip`` 127.0.0.1: its gRPC port requires client
  certificates from the manager's CA;
- ``--daemons`` daemons, each ``cli.dfdaemon.build`` at the
  ``DaemonConfig`` defaults but for its storage under ``--out`` and a
  loopback piece server on port 0, with ``security.auto_issue`` and
  ``scheduler_grpc_tls`` (so it dials ``grpc://`` over mTLS and its piece
  plane serves and fetches over mTLS), and ``cli.dfdaemon.start_sni``
  hijacking the registry host; each announced once;
- the origin: one file of ``--file-mib`` MiB and an image of
  ``--layers-mib`` layers, made from ``--seed`` with numpy, under the
  hijacked host's ``https://`` URLs, answered in process (each daemon's
  back-to-source fetcher) after 20-25 ms, as a remote origin answers;
- a real TLS upstream for ``localhost`` (the host no daemon hijacks),
  its identity from a CA the bench makes.

Then every daemon downloads the file (daemon 0 first, from the origin,
then the others at the same time, from the swarm); then one client a
daemon pulls every layer over HTTPS through that daemon's SNI proxy,
trusting its ``sni-ca.pem``; then one client reaches ``localhost``
through daemon 0's proxy and the upstream's bytes come back unchanged.

The summary holds the download and pull rates, the per-download seconds
and the layers' first-byte seconds (p50 and p99), the TLS handshakes the
piece servers accepted, the pieces by where they came from, the identity
issuance seconds at boot (from the first request the CA signed to the
last), the batcher's scorer calls and ``checks``.  Everything the run
wrote under ``--out`` is deleted at the end.

Runs on ``--device`` (``cuda`` by default; with no card it exits 2).
Prints one JSON line.

    python -m dragonfly2_tpu_torch.bench.secure_cluster [--daemons 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import shutil
import socket
import ssl
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from .peer_swarm import _task_sha256, daemon_config, engine_report, finish_engine
from .registry_proxy import _percentile, _task_pieces

HIJACKED = "registry.secure.test"
HIJACK_RULE = r"^registry\.secure\.test$"
FILE_PATH = "/files/blob.bin"
REPO_PATH = "/v2/library/app"
ORIGIN_DELAY_S = (0.020, 0.025)
# Threads every part of the cluster starts, by name: none may outlive
# the run (the renewers, the SNI listeners, the HTTP services).
OWNED_THREADS = ("mtls-renew", "sni-proxy", "piece-http", "manager-rest",
                 "scheduler-http", "upstream-tls")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--daemons", type=int, default=16)
    ap.add_argument("--file-mib", type=float, default=128.0)
    ap.add_argument("--layers-mib", default="1,4,16,64",
                    help="the image's layer sizes in MiB, comma-separated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="directory for every file of the run "
                    "(default: a fresh temporary directory); deleted after")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Origin:
    """The origin as each daemon's back-to-source fetcher: the file and the
    layers by URL, every call answered after 20-25 ms.  Counts the body
    bytes it served and the calls."""

    def __init__(self, bodies: dict, seed: int) -> None:
        self.bodies = bodies
        self.bytes_served = 0
        self.requests = 0
        self._mu = threading.Lock()
        self._rng = random.Random(seed)

    def _delay(self) -> None:
        with self._mu:
            d = self._rng.uniform(*ORIGIN_DELAY_S)
        time.sleep(d)

    def content_length(self, url: str, headers=None) -> int:
        self._delay()
        return len(self.bodies[url])

    def fetch(self, url: str, number: int, piece_size: int, headers=None) -> bytes:
        self._delay()
        body = self.bodies[url][number * piece_size:(number + 1) * piece_size]
        with self._mu:
            self.bytes_served += len(body)
            self.requests += 1
        return body


class Upstream:
    """A real TLS server for ``localhost`` that answers each connection's
    first read with a fixed body: what a relayed client must see byte for
    byte."""

    def __init__(self, identity, body: bytes) -> None:
        from ..security.tls import _materialized

        self.body = body
        self.ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        with _materialized(identity) as paths:
            self.ctx.load_cert_chain(paths["cert"], paths["key"])
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.port = self._listener.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, name="upstream-tls",
                                        daemon=True)

    def _serve(self) -> None:
        try:
            conn, _ = self._listener.accept()
        except OSError:
            return
        with self.ctx.wrap_socket(conn, server_side=True) as tls:
            tls.recv(4096)
            tls.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: " + str(len(self.body)).encode()
                        + b"\r\nConnection: close\r\n\r\n" + self.body)

    def serve(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._listener.close()
        self._thread.join(timeout=10)


def _rest(url: str, payload=None, token=None):
    """→ (status, JSON body) of one manager REST call."""
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _https_get(port: int, host: str, path: str, cafile: str, *, cadata=None):
    """GET ``path`` over TLS to 127.0.0.1:``port`` with SNI ``host``,
    verifying the server against ``cafile`` (or ``cadata``) and the host
    name → (status line, sha256 of the body, body bytes, seconds to the
    first body byte, body)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cafile=cafile, cadata=cadata)
    with socket.create_connection(("127.0.0.1", port), timeout=120) as raw:
        with ctx.wrap_socket(raw, server_hostname=host) as tls:
            t0 = time.perf_counter()
            tls.sendall(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
            # A bytearray grows in place: TLS hands back at most a 16 KiB
            # record a read, and a bytes concatenation would copy the
            # whole body on each.
            resp, first_s = bytearray(), None
            while True:
                chunk = tls.recv(1 << 20)
                if not chunk:
                    break
                if first_s is None:
                    first_s = time.perf_counter() - t0
                resp += chunk
    head, _, body = bytes(resp).partition(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0].decode("latin-1")
    return status, hashlib.sha256(body).hexdigest(), len(body), first_s, body


def _chains_to(identity, ca_pem: bytes) -> bool:
    """The identity's trust root is ``ca_pem`` and its certificate
    validates under it: an in-memory mutual-TLS handshake between the
    identity's own server and client contexts, each verifying the other
    against that root."""
    from ..security.tls import client_context, server_context

    if identity is None or identity.ca_pem != ca_pem:
        return False
    bios = [ssl.MemoryBIO() for _ in range(4)]
    try:
        ends = [client_context(identity).wrap_bio(bios[0], bios[1]),
                server_context(identity).wrap_bio(bios[2], bios[3], server_side=True)]
    except ssl.SSLError:  # a key that does not match its certificate
        return False
    done = [False, False]
    for _ in range(8):
        for k, end in enumerate(ends):
            if not done[k]:
                try:
                    end.do_handshake()
                    done[k] = True
                except ssl.SSLWantReadError:
                    pass
                except ssl.SSLError:
                    return False
        bios[2].write(bios[1].read())  # client → server
        bios[0].write(bios[3].read())  # server → client
        if all(done):
            return True
    return False


def _piece_server_refuses_anonymous(port: int) -> bool:
    anon = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    anon.check_hostname = False
    anon.verify_mode = ssl.CERT_NONE
    try:
        urllib.request.urlopen(f"https://127.0.0.1:{port}/healthy", context=anon,
                               timeout=10).read()
    except (urllib.error.URLError, ssl.SSLError, ConnectionError, OSError):
        return True
    return False


def _grpc_answer(target: str, credentials) -> str:
    """The status of one ``sync_probes_start`` call on the scheduler's gRPC
    port over ``credentials``: ``OK`` or the gRPC code's name."""
    from ..rpc import grpc_transport as gt

    req_cls, resp_cls = gt.SCHEDULER_METHODS["sync_probes_start"]
    channel = gt.grpc.secure_channel(target, credentials)
    try:
        call = channel.unary_unary(f"/{gt.SCHEDULER_SERVICE}/sync_probes_start",
                                   request_serializer=lambda m: m.SerializeToString(),
                                   response_deserializer=resp_cls.FromString)
        try:
            call(req_cls(), timeout=10)
        except gt.grpc.RpcError as exc:
            return exc.code().name
        return "OK"
    finally:
        channel.close()


def _stop_node(node: dict) -> None:
    node["announcer"].stop()
    node["piece_server"].stop()
    if node["renewer"] is not None:
        node["renewer"].stop()


def _owned_threads() -> list:
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(OWNED_THREADS))


def run(args: argparse.Namespace, *, log=print) -> dict:
    from ..cli import dfdaemon
    from ..cli import manager as manager_cli
    from ..cli import scheduler as scheduler_cli
    from ..config import ManagerConfig, SchedulerConfigFile
    from ..rpc import grpc_transport as gt
    from ..security.ca import CertificateAuthority, PeerIdentity
    from ..utils import idgen
    from .wire_loop import seeded_k1_blob

    out_dir = args.out or tempfile.mkdtemp(prefix="secure_cluster-")
    work = os.path.join(out_dir, "secure_cluster")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)
    file_size = int(args.file_mib * (1 << 20))
    file_body = rng.bytes(file_size)
    sizes = [int(float(m) * (1 << 20)) for m in args.layers_mib.split(",")]
    layers = [rng.bytes(s) for s in sizes]
    image_bytes = sum(sizes)
    file_url = f"https://{HIJACKED}{FILE_PATH}"
    layer_paths = [f"{REPO_PATH}/blobs/sha256:{hashlib.sha256(b).hexdigest()}"
                   for b in layers]
    layer_urls = [f"https://{HIJACKED}{p}" for p in layer_paths]
    origin = Origin({file_url: file_body, **dict(zip(layer_urls, layers))}, args.seed)
    # The DaemonConfig default, which the SNI proxies also take.
    piece_size = 4 << 20
    threads_before = set(_owned_threads())
    mgr = serving = upstream = summary = None
    nodes, snis = [], []
    signed: list = []
    try:
        t_setup = time.perf_counter()
        # -- the manager: cluster CA, users, PATs ----------------------------
        mc = ManagerConfig()
        mc.server.host, mc.server.port = "127.0.0.1", 0
        mc.registry.blob_dir = os.path.join(work, "manager")
        mc.ca_dir = os.path.join(work, "manager", "ca")
        mc.token_secret = hashlib.sha256(f"secure-cluster-{args.seed}".encode()).hexdigest()[:32]
        mc.users_db = os.path.join(work, "manager", "users.db")
        mc.root_password = f"root-password-{args.seed}"
        mgr = manager_cli.serve(mc)
        ca = mgr.parts["ca"]
        sign = ca.sign_csr

        def timed_sign(csr_pem, **kw):
            t = time.perf_counter()
            cert = sign(csr_pem, **kw)
            signed.append((t, time.perf_counter()))
            return cert

        ca.sign_csr = timed_sign
        api = mgr.url + "/api/v1"
        _, root = _rest(api + "/users:signin", {"name": "root", "password": mc.root_password})
        _, peer_pat = _rest(api + "/pats", {"name": "cluster", "role": "peer"}, root["token"])
        _, op_pat = _rest(api + "/pats", {"name": "bench", "role": "operator"}, root["token"])

        # -- the scheduler: auto-issued identity, mTLS gRPC ------------------
        cfg = SchedulerConfigFile()
        cfg.server.host, cfg.server.port, cfg.server.grpc_port = "127.0.0.1", 0, 0
        cfg.server.advertise_ip = "127.0.0.1"
        cfg.storage.dir = os.path.join(work, "records")
        cfg.scheduling.algorithm = "ml"
        # As the other serving phases: a cold task's first register goes
        # back to source without sleeping out the retry loop.
        cfg.scheduling.retry_interval_s = 0.0
        cfg.manager_addr, cfg.manager_token = mgr.url, peer_pat["token"]
        cfg.security.auto_issue = True
        serving = scheduler_cli.serve(cfg, device=args.device,
                                      scorer_blob=seeded_k1_blob(args.seed),
                                      rng=random.Random(args.seed))
        service = serving.service
        ev = service.scheduling.evaluator
        target = serving.grpc_server.target

        # -- the daemons: auto-issued identities, mTLS piece plane, SNI ------
        for i in range(args.daemons):
            dc = daemon_config(args, os.path.join(work, f"daemon{i}"), piece_size)
            dc.manager_addr, dc.manager_token = mgr.url, peer_pat["token"]
            dc.security.auto_issue = True
            dc.proxy.sni_port = 0
            dc.proxy.sni_hijack_hosts = [HIJACK_RULE]
            parts = dfdaemon.build(dc, f"grpc://{target}")
            parts["conductor"].source_fetcher = origin
            nodes.append(parts)
            sni, ca_path = dfdaemon.start_sni(parts, dc)
            snis.append((sni, ca_path))
        for n in nodes:
            n["announcer"].announce_once()
        host_names = {n["host"].id: f"daemon{i}" for i, n in enumerate(nodes)}
        setup_s = time.perf_counter() - t_setup
        calls0 = ev.batcher.scorer_calls
        log(f"secure_cluster: {args.daemons} daemons, a {file_size}-byte file and "
            f"{len(sizes)} layers of {image_bytes} bytes, scheduler grpc://{target} "
            f"(mTLS), manager {mgr.url} ({setup_s:.1f}s setup)")

        # -- the downloads ---------------------------------------------------
        results: list = [None] * args.daemons

        def download(i: int) -> None:
            conductor = nodes[i]["conductor"]
            results[i] = conductor.download(
                file_url, piece_size=piece_size,
                content_length=conductor.probe_content_length(file_url))

        t0 = time.perf_counter()
        download(0)
        threads = [threading.Thread(target=download, args=(i,), name=f"daemon{i}-dl",
                                    daemon=True) for i in range(1, args.daemons)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        download_s = time.perf_counter() - t0
        file_sha = hashlib.sha256(file_body).hexdigest()
        file_shas = [_task_sha256(n["storage"], r.task_id) if r is not None and r.ok else ""
                     for n, r in zip(nodes, results)]

        # -- the pulls through the SNI proxies -------------------------------
        pulls: list = [None] * args.daemons
        start = threading.Barrier(args.daemons)

        def client(i: int) -> None:
            port, cafile = snis[i][0].port, snis[i][1]
            out = []
            start.wait()
            for path, body in zip(layer_paths, layers):
                status, sha, n, first_s, _ = _https_get(port, HIJACKED, path, cafile)
                out.append({"status": status, "sha_ok": sha == hashlib.sha256(body).hexdigest(),
                            "bytes": n, "first_byte_s": first_s})
            pulls[i] = out

        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,), name=f"puller{i}", daemon=True)
                   for i in range(args.daemons)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        pull_s = time.perf_counter() - t1
        scorer_calls = ev.batcher.scorer_calls - calls0

        # -- the relay of a host no daemon hijacks ---------------------------
        relay_ca = CertificateAuthority()
        relay_body = rng.bytes(4096)
        upstream = Upstream(PeerIdentity.issue(relay_ca, common_name="localhost",
                                               hostnames=["localhost"]), relay_body)
        upstream.serve()
        snis[0][0].relay_port = upstream.port
        relay_status, _, _, _, relayed = _https_get(
            snis[0][0].port, "localhost", "/", None, cadata=relay_ca.cert_pem.decode())

        # -- the security checks ---------------------------------------------
        ca_pem = ca.cert_pem
        identities = [serving.identity] + [n["identity"] for n in nodes]
        anon_pieces = _piece_server_refuses_anonymous(nodes[-1]["piece_server"].port)
        no_cert = _grpc_answer(target, gt.grpc.ssl_channel_credentials(root_certificates=ca_pem))
        ident = nodes[0]["identity"]
        with_cert = _grpc_answer(target, gt.grpc.ssl_channel_credentials(
            root_certificates=ca_pem, private_key=ident.key_pem,
            certificate_chain=ident.cert_pem))
        model = {"name": "m", "type": "mlp", "scheduler_id": serving.scheduler_id}
        anon_create, _ = _rest(api + "/models", model)
        _, created = _rest(api + "/models", model, peer_pat["token"])
        peer_activate, _ = _rest(api + f"/models/{created['id']}:activate", {},
                                 peer_pat["token"])
        peer_users, _ = _rest(api + "/users", None, peer_pat["token"])
        op_activate, activated = _rest(api + f"/models/{created['id']}:activate", {},
                                       op_pat["token"])
        # Deactivated at once: the scheduler's subscription keeps the seeded
        # scorer (the model's artifact is empty).
        _rest(api + f"/models/{created['id']}:deactivate", {}, op_pat["token"])

        # -- accounting ------------------------------------------------------
        tids = {idgen.task_id(file_url)} | {idgen.task_id(u) for u in layer_urls}
        by_parent = _task_pieces(service, tids, host_names)
        p2p_pieces = sum(v for k, v in by_parent.items() if k != "source")
        handshakes = sum(n["piece_server"]._svc._httpd.socket.context.session_stats()[
            "accept_good"] for n in nodes)
        engine = engine_report(nodes)
        costs = [r.cost_s for r in results if r is not None]
        firsts = [x["first_byte_s"] for p in pulls if p for x in p
                  if x["first_byte_s"] is not None]
        summary = {
            "daemons": args.daemons, "file_bytes": file_size, "layer_bytes": sizes,
            "image_bytes": image_bytes, "piece_size": piece_size, "setup_seconds": setup_s,
            "download_seconds_wall": download_s,
            "download_mb_s": args.daemons * file_size / download_s / 1e6,
            "download_seconds": {"p50": _percentile(costs, 50), "p99": _percentile(costs, 99)},
            "pull_seconds": pull_s,
            "pull_mb_s": args.daemons * image_bytes / pull_s / 1e6,
            "layer_first_byte_s": {"p50": _percentile(firsts, 50),
                                   "p99": _percentile(firsts, 99)},
            "tls_handshakes": handshakes,
            "pieces_by_parent": by_parent, "p2p_pieces": p2p_pieces,
            "origin": {"bytes": origin.bytes_served, "requests": origin.requests},
            "identities": len(signed),
            "identity_issuance_s": signed[-1][1] - signed[0][0] if signed else 0.0,
            "sni_stats": {k: sum(s.stats[k] for s, _ in snis)
                          for k in ("hijacked", "relayed", "rejected")},
            "grpc": {"no_client_cert": no_cert, "client_cert": with_cert},
            "rest": {"anonymous_create": anon_create, "peer_activate": peer_activate,
                     "peer_list_users": peer_users, "operator_activate": op_activate},
            "scorer_calls": scorer_calls, "rule_degrades": ev.degrades,
            "batcher_fallbacks": ev.batcher.fallbacks, "engine": engine,
        }
        checks = {
            "identities_chain_to_the_manager_ca": len(identities) == args.daemons + 1
            and all(_chains_to(x, ca_pem) for x in identities)
            and len(signed) == len(identities),
            "anonymous_piece_client_refused": anon_pieces,
            "grpc_refuses_a_channel_without_a_client_cert":
            no_cert == "UNAVAILABLE" and with_cert != "UNAVAILABLE",
            # The reference's answers: 401 for no credential and for a role
            # below the route's (model activation needs OPERATOR), 403 on the
            # ADMIN-gated user listing.
            "rest_roles_enforced": anon_create == 401 and peer_activate == 401
            and peer_users == 403 and op_activate == 200
            and activated.get("state") == "active",
            "downloads_sha256_equal": all(r is not None and r.ok for r in results)
            and all(s == file_sha for s in file_shas),
            "pulls_sha256_equal": all(p and all(x["status"].startswith("HTTP/1.1 200")
                                                and x["sha_ok"] for x in p) for p in pulls),
            "unmatched_host_relayed_byte_for_byte": relay_status.startswith("HTTP/1.1 200")
            and relayed == relay_body,
            "sni_stats": summary["sni_stats"] == {"hijacked": args.daemons * len(sizes),
                                                  "relayed": 1, "rejected": 0},
            "every_piece_over_tls": engine["piece_servers"] == ["PieceHTTPServer"]
            and all(n["piece_server"]._svc.url.startswith("https://") for n in nodes)
            and engine["native_fetch_pieces"] == 0 and handshakes > 0 and p2p_pieces > 0,
            "scorer_called": scorer_calls >= 1,
            "no_degrade": ev.degrades == 0 and ev.batcher.fallbacks == 0,
        }
        summary["checks"] = checks
    finally:
        if upstream is not None:
            upstream.stop()
        for sni, _ in snis:
            sni.stop()
        # Side by side: each HTTP server's stop waits out its poll interval.
        stoppers = [threading.Thread(target=_stop_node, args=(n,), name=f"stop{i}", daemon=True)
                    for i, n in enumerate(nodes)]
        for th in stoppers:
            th.start()
        for th in stoppers:
            th.join()
        if serving is not None:
            serving.stop()
        if mgr is not None:
            mgr.stop()
        shutil.rmtree(work, ignore_errors=True)
        if not args.out:
            shutil.rmtree(out_dir, ignore_errors=True)
    deadline = time.monotonic() + 10.0
    left = [t for t in _owned_threads() if t not in threads_before]
    while left and time.monotonic() < deadline:
        time.sleep(0.05)
        left = [t for t in _owned_threads() if t not in threads_before]
    summary["threads_left"] = left
    summary["checks"]["no_thread_left"] = not left
    finish_engine(summary)
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("secure_cluster: no CUDA device", file=sys.stderr)
            return 2
    summary = run(args, log=lambda line: print(line, file=sys.stderr))
    print(json.dumps(summary))
    return 0 if all(summary["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
