"""Port parity: peer exchange over the net, ``dragonfly2_tpu_torch/daemon/
pex_net.py``, against ``dragonfly2_tpu/daemon/pex_net.py``.

- The piece-range codec, and the datagrams themselves: one scripted
  exchange (join, a peer's join and advertisement, a sync request, an
  advertisement, a retraction, a leave) against a recording UDP socket,
  from a bus of each package bound to the same port in turn: the
  datagrams are byte-equal, in the same order.
- The port counterparts of ``tests/test_pex_net.py:48-150``: discovery
  and the late joiner's sync, retraction and reclaim on leave, heartbeat
  failure detection, and discovery surviving the scheduler's death across
  processes (the port's scheduler and ``dfdaemon --pex-port`` binaries;
  then both a port client and a JAX client find the holder over gossip
  alone and download its pieces).
- One port member and one JAX member on one gossip bus, each seeing the
  other's pieces and metadata.
"""

from __future__ import annotations

import errno
import json
import os
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import dragonfly2_tpu.daemon.pex as jpex
import dragonfly2_tpu.daemon.pex_net as jnet
import dragonfly2_tpu_torch.daemon.pex as tpex
import dragonfly2_tpu_torch.daemon.pex_net as tnet

PIECE = 32 * 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jpex, jnet), "port": (tpex, tnet)}


def _node(pkg, name, seeds=(), interval=0.1, port=0):
    pex_mod, net = PACKAGES[pkg]
    bus = net.NetworkedGossipBus(port=port, seeds=list(seeds), gossip_interval_s=interval)
    pex = pex_mod.PeerExchange(pex_mod.MemberMeta(host_id=name, ip="127.0.0.1", port=1000), bus)
    pex.serve()
    return bus, pex


def _wait(cond, timeout=15.0):
    """Poll ``cond`` (gossip converges in a few intervals; the bound is
    for a loaded machine)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


# -- the codec and the datagrams ------------------------------------------


@pytest.mark.parametrize("pieces", [set(), {0}, {0, 1, 2, 7, 9, 10}, set(range(100)),
                                    set(range(0, 10_000, 3))])
def test_ranges_roundtrip_and_match(pieces):
    ranges = tnet.pieces_to_ranges(pieces)
    assert ranges == jnet.pieces_to_ranges(pieces)
    assert tnet.ranges_to_pieces(ranges) == pieces == jnet.ranges_to_pieces(ranges)


def test_contiguous_compact():
    assert tnet.pieces_to_ranges(set(range(10_000))) == [[0, 9999]]


def _free_udp_ports(n=2):
    """``n`` distinct free UDP ports (held open together while drawn)."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _scripted_exchange(pkg, port, rec_port):
    """The bus of ``pkg`` on ``port``, one recording peer on ``rec_port``:
    → the datagrams the bus sent, in order, and what its pool held."""
    rec = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rec.bind(("127.0.0.1", rec_port))
    rec.settimeout(5.0)
    got = []

    def drain(n):
        for _ in range(n):
            got.append(rec.recv(65536))

    def send(msg):
        rec.sendto(json.dumps(msg).encode(), ("127.0.0.1", port))

    rec_meta = {"host_id": "rec", "ip": "127.0.0.1", "port": 2000,
                "gossip": ["127.0.0.1", rec.getsockname()[1]]}
    # A long interval: no heartbeat or anti-entropy tick in the script.
    bus, pex = _node(pkg, "host-x", seeds=[("127.0.0.1", rec.getsockname()[1])],
                     interval=60.0, port=port)
    try:
        drain(2)                                   # join, sync_req
        pex.advertise("task-1", {0, 1, 2, 5})      # no peer yet: nothing sent
        send({"t": "join", "meta": rec_meta})
        drain(2)                                   # join back, adv of task-1
        send({"t": "adv", "src": "rec", "task": "task-2", "ranges": [[0, 3], [8, 8]]})
        assert _wait(lambda: pex.find_peers_with_piece("task-2", 8) == ["rec"])
        send({"t": "sync_req", "meta": rec_meta})
        drain(2)                                   # sync: members, holdings
        pex.advertise("task-3", set(range(1000)) | {2000})
        drain(1)
        pex.retract("task-1")
        drain(1)
        pool = sorted((h, t, sorted(p)) for h, t, p in pex.pool_snapshot())
        members = sorted(m.host_id for m in pex.members())
        pex.stop()
        drain(1)                                   # leave
        # The bus's receive thread holds its closed socket (and the port)
        # until a datagram wakes it: wake it, and wait for the port.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            send({"t": "wake"})
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                probe.bind(("127.0.0.1", port))
                break
            except OSError:
                time.sleep(0.05)
            finally:
                probe.close()
    finally:
        rec.close()
    return got, pool, members


def test_datagrams_are_byte_equal():
    # Both buses take the same two ports in turn; another process may take
    # one between the turns, and then the pair is drawn again.
    for attempt in range(5):
        port, rec_port = _free_udp_ports()
        try:
            jax_side = _scripted_exchange("jax", port, rec_port)
            port_side = _scripted_exchange("port", port, rec_port)
            break
        except OSError as exc:
            if exc.errno != errno.EADDRINUSE or attempt == 4:
                raise
    assert port_side == jax_side
    kinds = [json.loads(d)["t"] for d in port_side[0]]
    assert kinds == ["join", "sync_req", "join", "adv", "sync", "sync", "adv", "ret", "leave"]
    assert json.loads(port_side[0][6])["ranges"] == [[0, 999], [2000, 2000]]


# -- the port counterparts of tests/test_pex_net.py ------------------------


def test_discovery_and_late_join_sync():
    bus_a, pex_a = _node("port", "host-a")
    bus_b, pex_b = _node("port", "host-b", seeds=[bus_a.address])
    try:
        assert _wait(lambda: pex_a.member("host-b") is not None)
        assert _wait(lambda: pex_b.member("host-a") is not None)
        pex_a.advertise("task-1", {0, 1, 2})
        assert _wait(lambda: pex_b.find_peers_with_piece("task-1", 1) == ["host-a"])
        bus_c, pex_c = _node("port", "host-c", seeds=[bus_b.address])
        try:
            assert _wait(lambda: "host-a" in pex_c.find_peers_with_task("task-1"))
            assert pex_c.member("host-a").port == 1000
        finally:
            pex_c.stop()
    finally:
        pex_b.stop()
        pex_a.stop()


def test_retract_and_reclaim_on_leave():
    bus_a, pex_a = _node("port", "host-a")
    bus_b, pex_b = _node("port", "host-b", seeds=[bus_a.address])
    bus_c, pex_c = _node("port", "host-c", seeds=[bus_a.address])
    try:
        assert _wait(lambda: len(pex_a.members()) == 2)
        pex_b.advertise("task-r", {0})
        pex_c.advertise("task-r", {0, 1})
        assert _wait(lambda: sorted(pex_a.find_peers_with_task("task-r")) == ["host-b", "host-c"])
        pex_b.retract("task-r")
        assert _wait(lambda: pex_a.find_peers_with_task("task-r") == ["host-c"])
        pex_c.stop()
        assert _wait(lambda: pex_a.find_peers_with_task("task-r") == [])
        assert pex_a.member("host-c") is None
    finally:
        pex_b.stop()
        pex_a.stop()


def test_heartbeat_failure_detection():
    bus_a, pex_a = _node("port", "host-a", interval=0.1)
    bus_b, pex_b = _node("port", "host-b", seeds=[bus_a.address], interval=0.1)
    try:
        assert _wait(lambda: pex_a.member("host-b") is not None)
        pex_b.advertise("task-h", {0})
        assert _wait(lambda: pex_a.find_peers_with_task("task-h"))
        bus_b._stop.set()           # a crash: no leave message
        bus_b._sock.close()
        assert _wait(lambda: pex_a.member("host-b") is None, timeout=5), \
            "dead member never reclaimed"
        assert pex_a.find_peers_with_task("task-h") == []
    finally:
        pex_a.stop()


def test_a_port_member_and_a_jax_member_share_one_bus():
    bus_j, pex_j = _node("jax", "jax-host")
    bus_t, pex_t = _node("port", "port-host", seeds=[bus_j.address])
    try:
        assert _wait(lambda: pex_j.member("port-host") is not None)
        assert _wait(lambda: pex_t.member("jax-host") is not None)
        pex_j.advertise("task-j", {0, 1, 2})
        pex_t.advertise("task-t", set(range(64)))
        assert _wait(lambda: pex_t.find_peers_with_piece("task-j", 2) == ["jax-host"])
        assert _wait(lambda: pex_j.find_peers_with_piece("task-t", 63) == ["port-host"])
        assert (pex_t.member("jax-host").ip, pex_t.member("jax-host").port) == ("127.0.0.1", 1000)
        pex_j.retract("task-j")
        assert _wait(lambda: pex_t.find_peers_with_task("task-j") == [])
        pex_t.stop()
        assert _wait(lambda: pex_j.member("port-host") is None)
        assert pex_j.find_peers_with_task("task-t") == []
    finally:
        pex_j.stop()
        pex_t.stop()


class _RangeOrigin(BaseHTTPRequestHandler):
    BLOB = bytes(i % 253 for i in range(4 * PIECE))

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.BLOB)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        time.sleep(0.02)  # a remote origin's latency
        rng = self.headers.get("Range")
        body, code = self.BLOB, 200
        if rng:
            s, e = rng.split("=", 1)[1].split("-")
            body = self.BLOB[int(s): (int(e) if e else len(self.BLOB) - 1) + 1]
            code = 206
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _gossip_client(pkg, tmp_path, pex_port, sched_url, url):
    """A client that joins only the gossip and downloads ``url`` through
    the holder it finds there, with the scheduler dead."""
    import importlib

    root = "dragonfly2_tpu" if pkg == "jax" else "dragonfly2_tpu_torch"
    daemon = importlib.import_module(f"{root}.daemon")
    conductor_mod = importlib.import_module(f"{root}.daemon.conductor")
    rpc = importlib.import_module(f"{root}.rpc")
    resource = importlib.import_module(f"{root}.scheduler.resource")
    idgen = importlib.import_module(f"{root}.utils.idgen")
    bus, pex = _node(pkg, f"{pkg}-client", seeds=[("127.0.0.1", pex_port)])
    try:
        task_id = idgen.task_id(url)
        assert _wait(lambda: pex.find_peers_with_task(task_id), timeout=10), \
            "gossip never surfaced the holder"

        def resolve(host_id):
            m = pex.member(host_id)
            assert m is not None
            return m.ip, m.port

        storage = daemon.DaemonStorage(str(tmp_path / f"{pkg}-clientstore"), prefer_native=False)
        conductor = conductor_mod.Conductor(
            resource.Host(id=f"{pkg}-client", hostname="c", ip="127.0.0.1", download_port=1),
            storage, rpc.RemoteScheduler(sched_url, timeout=1.0),
            piece_fetcher=rpc.HTTPPieceFetcher(resolve), source_fetcher=None, pex=pex)
        r = conductor.download(url, piece_size=PIECE, content_length=len(_RangeOrigin.BLOB))
        assert r.ok and r.pieces == 4
        assert storage.read_task_bytes(r.task_id) == _RangeOrigin.BLOB
    finally:
        pex.stop()


def test_discovery_survives_scheduler_death(tmp_path):
    procs = []

    def spawn(argv, prefixes, env):
        proc = subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONPATH": REPO, **env}, cwd=str(tmp_path))
        procs.append(proc)
        # A process that says nothing for 60 s is killed: readline then ends.
        watchdog = threading.Timer(60, proc.kill)
        watchdog.start()
        found, seen = {}, []
        try:
            while len(found) < len(prefixes):
                line = proc.stdout.readline()
                assert line, f"{argv} ended: {seen}"
                seen.append(line.strip())
                for p in prefixes:
                    if line.startswith(p):
                        found[p] = line.strip()
        finally:
            watchdog.cancel()
        return proc, found

    origin_srv = ThreadingHTTPServer(("127.0.0.1", 0), _RangeOrigin)
    threading.Thread(target=origin_srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{origin_srv.server_address[1]}/pex-blob"
    launcher = (
        "from dragonfly2_tpu_torch.cli.scheduler import serve\n"
        "from dragonfly2_tpu_torch.config import SchedulerConfigFile\n"
        "cfg = SchedulerConfigFile()\n"
        f"cfg.storage.dir = {str(tmp_path / 'records')!r}\n"
        "cfg.storage.buffer_size = 1\n"
        "cfg.server.host, cfg.server.port = '127.0.0.1', 0\n"
        "cfg.scheduling.retry_interval_s = 0.0\n"
        "srv = serve(cfg, device='cpu')\n"
        "print('READY', srv.url, flush=True)\n"
        "import time; time.sleep(300)\n"
    )
    try:
        sproc, out = spawn(["-c", launcher], ["READY"], {})
        sched_url = out["READY"].split()[1]
        _, dout = spawn(
            ["-m", "dragonfly2_tpu_torch.cli.dfdaemon", "--scheduler", sched_url,
             "--pex-port", "0"],
            ["dfdaemon: pex gossip", "dfdaemon: serving"],
            {"DF_DAEMON_STATE": str(tmp_path / "d1.json"),
             "DRAGONFLY_DAEMON_SERVER_HOST": "127.0.0.1",
             "DRAGONFLY_DAEMON_SERVER_PORT": "0",
             "DRAGONFLY_DAEMON_SERVER_ADVERTISE_IP": "127.0.0.1",
             "DRAGONFLY_DAEMON_STORAGE_DIR": str(tmp_path / "dstore"),
             "DRAGONFLY_DAEMON_PIECE_SIZE": str(PIECE),
             "DRAGONFLY_DAEMON_METRICS_PORT": "0"},
        )
        pex_port = int(dout["dfdaemon: pex gossip"].rsplit(":", 1)[1])

        from dragonfly2_tpu_torch.rpc.daemon_control import download_via_daemon, read_state

        control = read_state(str(tmp_path / "d1.json"))["url"]
        r = download_via_daemon(url, control)
        assert r["ok"], r
        sproc.terminate()           # the scheduler dies
        sproc.wait(timeout=10)
        for pkg in ("port", "jax"):
            _gossip_client(pkg, tmp_path, pex_port, sched_url, url)
    finally:
        for proc in procs:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        origin_srv.shutdown()
