"""The peer daemon over the wire, on the CPU: the port's ``dfdaemon`` and
``dfget`` against the port's scheduler in serve mode, with K1 ranking
parents (the counterpart of ``tests/test_rpc.py``'s
``TestServiceBinaries``).

- The port's scheduler serves ``scheduling.algorithm: ml`` on the CPU
  with the seeded 32→64→64→1 K1 blob, so K1's plain version ranks every
  register.  Two port daemon builds: one goes back to source, the other
  downloads P2P from the parent K1 ranked.
- A mixed swarm: one JAX build and one port build, against the port's
  scheduler and against the JAX one, each order.  The bytes are equal and
  the second download is P2P, so each package's piece plane serves the
  other and each package's client speaks to the other's scheduler.
- ``cli.dfget.run`` embedded and through a daemon's control API, and
  ``cli.dfdaemon.run --download``.
- ``bench/peer_swarm.run`` (the smoke's phase 20) at a small size: six
  daemons, a 12 MiB file in 512 KiB pieces; every one of its checks
  holds.
- Every option the port does not carry yet exits 2 (or raises) naming
  its ROADMAP item; ``native_fetch: true`` and the native store, server
  and fetch loop, which once did, now build a native daemon.

The port's daemons run its native engine (the defaults); the JAX
daemons run their Python piece store, so a mixed swarm has each package's
client read the other engine's server.  Every
server and announcer is stopped in a ``finally``; every piece server
binds port 0 and ``DF_DAEMON_STATE`` points into the test's directory.
"""

from __future__ import annotations

import os
import random
import re
import time
import urllib.request

import numpy as np
import pytest

import dragonfly2_tpu.native as j_native
from dragonfly2_tpu.cli import dfdaemon as j_dfdaemon
from dragonfly2_tpu.cli import scheduler as j_scheduler_cli
from dragonfly2_tpu.config import DaemonConfig as JDaemonConfig
from dragonfly2_tpu.config import SchedulerConfigFile as JSchedulerConfigFile
from dragonfly2_tpu.rpc import SchedulerHTTPServer as JSchedulerHTTPServer
from dragonfly2_tpu_torch.bench.peer_swarm import served
from dragonfly2_tpu_torch.cli import dfdaemon, dfget
from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
from dragonfly2_tpu_torch.config import ConfigError, DaemonConfig, SchedulerConfigFile, load_config
from dragonfly2_tpu_torch.daemon import Conductor, DaemonStorage
from dragonfly2_tpu_torch.rpc.daemon_control import DaemonControlServer, write_state
from dragonfly2_tpu_torch.rpc.piece_transport import NativePieceServer, make_piece_server
from dragonfly2_tpu_torch.trainer.export import MLPScorer, scorer_to_bytes

PIECE = 65536


def seeded_blob(seed: int = 0) -> bytes:
    """The smoke's seeded 32→64→64→1 serving MLP (scale 0.3 / 0.05)."""
    rng = np.random.default_rng(seed)
    dims = (32, 64, 64, 1)
    weights = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
                rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
               for i in range(len(dims) - 1)]
    return scorer_to_bytes(MLPScorer(weights=weights))


@pytest.fixture()
def origin(tmp_path):
    payload = np.random.default_rng(7).bytes(5 * PIECE + 1234)
    path = tmp_path / "origin.bin"
    path.write_bytes(payload)
    return f"file://{path}", payload


@pytest.fixture()
def port_scheduler(tmp_path):
    cfg = SchedulerConfigFile()
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.storage.dir = str(tmp_path / "records")
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.retry_interval_s = 0.0
    serving = scheduler_cli.serve(cfg, device="cpu", scorer_blob=seeded_blob(),
                                  rng=random.Random(0))
    try:
        yield serving
    finally:
        serving.stop()


@pytest.fixture()
def jax_scheduler(tmp_path):
    cfg = JSchedulerConfigFile()
    cfg.storage.dir = str(tmp_path / "jax_records")
    cfg.scheduling.retry_interval_s = 0.0
    service, _storage, runner = j_scheduler_cli.build(cfg)
    srv = JSchedulerHTTPServer(service, port=0)
    srv.serve()
    try:
        yield srv
    finally:
        srv.stop()
        runner.stop()


def _daemon_cfg(cls, root):
    dc = cls()
    dc.storage.dir = str(root)
    dc.piece_size = PIECE
    dc.server.host = "127.0.0.1"
    dc.server.port = 0  # two daemons on one host
    dc.server.advertise_ip = "127.0.0.1"
    return dc


def build_port(root, url):
    return dfdaemon.build(_daemon_cfg(DaemonConfig, root), url)


def build_jax(root, url, monkeypatch):
    # The JAX daemon on its Python piece store, as the port's.
    monkeypatch.setattr(j_native, "available", lambda: False)
    parts = j_dfdaemon.build(_daemon_cfg(JDaemonConfig, root), url)
    assert not parts["storage"].is_native
    return parts


def stop_all(nodes):
    for n in nodes:
        n["announcer"].stop()
        n["piece_server"].stop()


def settled(cond, timeout=10.0) -> bool:
    """``cond()`` once it holds, polling up to ``timeout`` s: a piece server
    accounts a serve after it has written the body."""
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def read_back(parts, result, size):
    data = parts["storage"].read_task_bytes(result.task_id)
    assert len(data) == size
    return data


def test_port_daemons_k1_ranks_the_parents(tmp_path, monkeypatch, port_scheduler, origin):
    """Daemon 0 goes back to source, daemon 1 takes daemon 0's pieces (one
    candidate: nothing to rank), daemon 2 has two candidates, which K1
    ranks (its plain version, on the CPU)."""
    from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer

    src_url, payload = origin
    # Bad-node detection reads the wall-clock piece costs the daemons
    # report: on a loaded box one slow piece drops a parent.  Off here, so
    # daemon 2's candidate set is both parents on any box.
    ev = port_scheduler.service.scheduling.evaluator
    monkeypatch.setattr(ev, "is_bad_nodes", lambda peers: np.zeros(len(peers), bool))
    nodes = []
    try:
        for i in range(3):
            nodes.append(build_port(tmp_path / f"d{i}", port_scheduler.url))
        for n in nodes:
            n["announcer"].announce_once()
        r0 = nodes[0]["conductor"].download(src_url, piece_size=PIECE,
                                            content_length=len(payload))
        assert r0.ok and r0.back_to_source and r0.pieces == 6
        assert isinstance(ev._scorer, FusedMLPScorer)
        for n in nodes[1:]:
            r = n["conductor"].download(src_url, piece_size=PIECE)
            assert r.ok and not r.back_to_source and r.pieces == 6
            assert read_back(n, r, len(payload)) == payload
        assert settled(lambda: served(nodes[0])[0] + served(nodes[1])[0] == 12)
        assert ev.batcher.scorer_calls >= 1 and ev.degrades == 0
        port_scheduler.service.storage.flush()
        assert port_scheduler.service.storage.download_count == 3
    finally:
        stop_all(nodes)


@pytest.mark.parametrize("sched", ["port", "jax"])
@pytest.mark.parametrize("first", ["jax", "port"])
def test_mixed_swarm_is_p2p_across_packages(tmp_path, monkeypatch, request, origin, sched,
                                            first):
    src_url, payload = origin
    url = request.getfixturevalue(f"{sched}_scheduler").url
    builders = {"port": lambda root: build_port(root, url),
                "jax": lambda root: build_jax(root, url, monkeypatch)}
    second = "port" if first == "jax" else "jax"
    nodes = []
    try:
        nodes.append(builders[first](tmp_path / "first"))
        nodes.append(builders[second](tmp_path / "second"))
        for n in nodes:
            n["announcer"].announce_once()
        r0 = nodes[0]["conductor"].download(src_url, piece_size=PIECE,
                                            content_length=len(payload))
        assert r0.ok and r0.back_to_source
        r1 = nodes[1]["conductor"].download(src_url, piece_size=PIECE)
        assert r1.ok and not r1.back_to_source
        assert r1.task_id == r0.task_id
        assert r1.pieces == 6 and settled(lambda: served(nodes[0])[0] == 6)
        assert read_back(nodes[1], r1, len(payload)) == read_back(nodes[0], r0, len(payload)) \
            == payload
    finally:
        stop_all(nodes)


def test_dfget_embedded_and_through_the_daemon(tmp_path, monkeypatch, port_scheduler, origin,
                                               capsys):
    src_url, payload = origin
    out = tmp_path / "embedded.bin"
    assert dfget.run([src_url, "-O", str(out), "--work-dir", str(tmp_path / "w"),
                      "--piece-size", str(PIECE)]) == 0
    assert out.read_bytes() == payload
    assert "6 pieces, back-to-source" in capsys.readouterr().out

    monkeypatch.setenv("DF_DAEMON_STATE", str(tmp_path / "state" / "daemon.json"))
    parts = build_port(tmp_path / "daemon", port_scheduler.url)
    control = DaemonControlServer(parts["conductor"], piece_size=PIECE)
    control.serve()
    try:
        write_state(control.url)
        parts["announcer"].announce_once()
        out = tmp_path / "via_daemon.bin"
        assert dfget.run([src_url, "-O", str(out), "--daemon",
                          "--piece-size", str(PIECE)]) == 0
        assert out.read_bytes() == payload
        assert "via back-to-source through daemon" in capsys.readouterr().out
    finally:
        control.stop()
        stop_all([parts])


def test_dfdaemon_run_download(tmp_path, monkeypatch, port_scheduler, origin, capsys):
    src_url, payload = origin
    monkeypatch.setenv("DF_DAEMON_STATE", str(tmp_path / "daemon.json"))
    monkeypatch.setenv("DRAGONFLY_DAEMON_SERVER_PORT", "0")
    monkeypatch.setenv("DRAGONFLY_DAEMON_SERVER_HOST", "127.0.0.1")
    monkeypatch.setenv("DRAGONFLY_DAEMON_STORAGE_DIR", str(tmp_path / "store"))
    monkeypatch.setenv("DRAGONFLY_DAEMON_PIECE_SIZE", str(PIECE))
    monkeypatch.setenv("DRAGONFLY_DAEMON_METRICS_PORT", "0")
    out = tmp_path / "out.bin"
    assert dfdaemon.run(["--scheduler", port_scheduler.url, "--download", src_url,
                         "-O", str(out)]) == 0
    assert out.read_bytes() == payload
    text = capsys.readouterr().out
    assert "dfdaemon: 6 pieces via back-to-source" in text
    # The diagnostics sidecar started at boot, as the reference's does,
    # and the port stopped it when run returned.
    sidecar = re.search(r"dfdaemon: diagnostics on (http://127\.0\.0\.1:\d+)/metrics", text)
    assert sidecar, text
    with pytest.raises(OSError):
        urllib.request.urlopen(sidecar.group(1) + "/metrics", timeout=2)


def test_peer_swarm_small(tmp_path):
    from dragonfly2_tpu_torch.bench import peer_swarm

    summary = peer_swarm.run(peer_swarm.parse_args([
        "--daemons", "6", "--size-mib", "12", "--piece-kib", "512", "--seed", "3",
        "--out", str(tmp_path), "--device", "cpu"]), log=lambda line: None)
    assert summary["checks"] and all(summary["checks"].values()), summary
    assert summary["pieces"] == 24 and summary["download_records"] == 6
    assert summary["origin"]["bytes"] == 12 << 20
    assert summary["scorer_calls"] >= 1
    assert not os.path.exists(tmp_path / "peer_swarm")


@pytest.mark.parametrize("argv,env,config,item", [
    (["--seed-peer", "--pex-port", "0"], {}, None, "item 14"),
    (["--pex-port", "0"], {}, None, "item 14"),
    ([], {}, "security: {auto_issue: true}\n", "item 14"),
    ([], {}, "proxy: {sni_enable: true}\n", "item 14"),
    ([], {}, "metrics: {enable: true}\n", "ported"),
    ([], {"DRAGONFLY_DAEMON_NATIVE_FETCH": "true"}, None, "item 14"),
    ([], {"DRAGONFLY_DAEMON_CONTROL_VSOCK_PORT": "0"}, None, "item 14"),
    ("grpc", {}, None, "grpc"),
    ("list", {}, None, "grpc"),
])
def test_options_outside_the_slice_exit_2_naming_their_item(tmp_path, monkeypatch, capsys,
                                                            argv, env, config, item):
    monkeypatch.setenv("DF_DAEMON_STATE", str(tmp_path / "daemon.json"))
    monkeypatch.setenv("DRAGONFLY_DAEMON_SERVER_PORT", "0")
    monkeypatch.setenv("DRAGONFLY_DAEMON_STORAGE_DIR", str(tmp_path / "store"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    scheduler = "http://127.0.0.1:9"
    if argv == "grpc":
        argv, scheduler = [], "grpc://127.0.0.1:9"
    elif argv == "list":
        argv, scheduler = [], "http://127.0.0.1:9,grpc://127.0.0.1:10"
    if config is not None:
        (tmp_path / "daemon.yaml").write_text(config)
        argv = [*argv, "--config", str(tmp_path / "daemon.yaml")]
    if item == "ported":
        # Ported: the metrics section loads as the reference's.
        cfg = load_config(DaemonConfig, str(tmp_path / "daemon.yaml"))
        assert (cfg.metrics.enable, cfg.metrics.port) == (True, 8000)
        return
    if item == "grpc":
        # A grpc:// scheduler on a machine without grpc: exit 2, naming it.
        from _torch_nogrpc import block_grpc

        block_grpc(monkeypatch)
        assert dfdaemon.run(["--scheduler", scheduler, *argv]) == 2
        assert "'grpc' is not installed" in capsys.readouterr().err
        assert not os.path.exists(tmp_path / "daemon.json")
        return
    if env.get("DRAGONFLY_DAEMON_NATIVE_FETCH") == "true":
        # Ported: the config loads and validates, and a daemon built from
        # it runs the native store, server and fetch loop.
        cfg = load_config(DaemonConfig, None)
        cfg.validate()
        assert cfg.native_fetch
        parts = dfdaemon.build(cfg, scheduler)
        try:
            assert parts["conductor"].native_fetch and parts["storage"].is_native
            assert isinstance(parts["piece_server"], NativePieceServer)
        finally:
            stop_all([parts])
        return
    assert dfdaemon.run(["--scheduler", scheduler, *argv]) == 2
    err = capsys.readouterr().err
    assert f"ROADMAP queue 1 {item}" in err, err
    assert not os.path.exists(tmp_path / "daemon.json")


def test_native_paths_raise_naming_item_14(tmp_path):
    """The native paths are ported and are the defaults, as in the
    reference; only the vsock transport still raises naming item 14."""
    assert DaemonStorage(str(tmp_path / "n"), prefer_native=True).is_native
    storage = DaemonStorage(str(tmp_path / "s"))
    assert storage.is_native
    assert Conductor(None, storage, None, piece_fetcher=None, native_fetch=True).native_fetch
    from dragonfly2_tpu_torch.daemon import UploadManager

    server = make_piece_server(UploadManager(storage), port=0, prefer_native=True)
    try:
        assert isinstance(server, NativePieceServer) and server.port > 0
    finally:
        server.stop()
    DaemonConfig(native_fetch=True).validate()
    assert DaemonConfig().native_fetch
    control = DaemonControlServer(conductor=None)
    control.serve()
    try:
        with pytest.raises(NotImplementedError, match="item 14"):
            control.serve_vsock(0)
    finally:
        control.stop()
