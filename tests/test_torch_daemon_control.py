"""Port parity: the dfget→daemon contract, ``dragonfly2_tpu_torch``
against ``dragonfly2_tpu``.

The cases of ``tests/test_daemon_control.py`` on the port: the control
API, state-file discovery, auto-spawn (of the port's ``dfdaemon``, against
the port's scheduler binary on the CPU) and the debug endpoint.  Then the
two packages' control APIs answer the same requests with equal JSON
bodies, and ``ensure_daemon`` spawns ``dragonfly2_tpu_torch.cli.dfdaemon``
(never the JAX package's daemon).  Every spawned process is killed in a
``finally``, and ``DF_DAEMON_STATE`` points into the test's directory.
"""

import json
import os
import subprocess
import sys
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from dragonfly2_tpu_torch.rpc.daemon_control import (
    DaemonControlServer,
    daemon_healthy,
    download_via_daemon,
    read_state,
    write_state,
)

from tests.test_torch_daemon import PIECE, _Swarm


def _ready_url(proc) -> str:
    """The URL of the launcher's READY line (the port's scheduler prints
    its own boot line first)."""
    for line in proc.stdout:
        if line.startswith("READY"):
            return line.split()[1]
    raise RuntimeError("the scheduler process exited before READY")


class TestControlServer:
    def test_healthy_and_download(self, tmp_path):
        swarm = _Swarm(tmp_path, n_hosts=2)
        swarm.origin.content_length = lambda u: 3 * PIECE
        d = swarm.daemons[0]
        srv = DaemonControlServer(d.conductor, piece_size=PIECE)
        srv.serve()
        try:
            assert daemon_healthy(srv.url)
            out_file = str(tmp_path / "via-daemon.bin")
            result = download_via_daemon(
                "https://origin/ctl-blob", srv.url, output=out_file,
                piece_size=PIECE,
            )
            assert result["ok"] and result["pieces"] == 3
            expected = b"".join(
                swarm.origin.content("https://origin/ctl-blob", n)
                for n in range(3)
            )
            with open(out_file, "rb") as f:
                assert f.read() == expected
        finally:
            srv.stop()

    def test_state_file_roundtrip(self, tmp_path, monkeypatch):
        path = str(tmp_path / "daemon.json")
        monkeypatch.setenv("DF_DAEMON_STATE", path)
        write_state("http://127.0.0.1:1234")
        state = read_state()
        assert state["url"] == "http://127.0.0.1:1234"
        assert state["pid"] == os.getpid()
        assert not daemon_healthy(state["url"])  # nothing listening

    def test_failed_download_returns_dict_not_traceback(self, tmp_path):
        """Error statuses carry the JSON result back to the caller — the
        dfget ok-check path must be reachable."""
        swarm = _Swarm(tmp_path, n_hosts=1)
        d = swarm.daemons[0]
        d.conductor.source_fetcher = None  # downloads will fail
        srv = DaemonControlServer(d.conductor, piece_size=PIECE)
        srv.serve()
        try:
            result = download_via_daemon(
                "https://origin/doomed", srv.url, piece_size=PIECE
            )
            assert result["ok"] is False
        finally:
            srv.stop()

    def test_bad_request_rejected(self, tmp_path):
        swarm = _Swarm(tmp_path, n_hosts=1)
        d = swarm.daemons[0]
        srv = DaemonControlServer(d.conductor)
        srv.serve()
        try:
            req = urllib.request.Request(
                srv.url + "/download", data=b"{}",
                headers={"Content-Type": "application/json"}, method="POST",
            )
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=5)
            assert exc.value.code == 400
        finally:
            srv.stop()


class TestDfgetDaemonSpawn:
    def test_spawn_download_reuse(self, tmp_path):
        """dfget --daemon: spawns a dfdaemon against a real scheduler
        process, downloads through it, and a second dfget reuses the SAME
        daemon (no second spawn)."""
        env = {
            **os.environ,
            "PYTHONPATH": REPO,
            "DF_DAEMON_STATE": str(tmp_path / "daemon.json"),
        }
        sched_cfg = tmp_path / "sched.yaml"
        sched_cfg.write_text(
            f"storage:\n  dir: {tmp_path}/records\n"
            "server:\n  host: 127.0.0.1\n  port: 0\n"
        )
        launcher = (
            "import sys\n"
            "from dragonfly2_tpu_torch.cli.scheduler import serve\n"
            "from dragonfly2_tpu_torch.config import SchedulerConfigFile, load_config\n"
            "cfg = load_config(SchedulerConfigFile, sys.argv[1])\n"
            "srv = serve(cfg, device='cpu')\n"
            "print('READY', srv.url, flush=True)\n"
            "import time; time.sleep(120)\n"
        )
        sched = subprocess.Popen(
            [sys.executable, "-c", launcher, str(sched_cfg)],
            stdout=subprocess.PIPE, text=True, env=env,
        )
        daemon_pid = None
        try:
            sched_url = _ready_url(sched)
            daemon_cfg = tmp_path / "daemon.yaml"
            daemon_cfg.write_text(
                f"storage:\n  dir: {tmp_path}/dstore\n"
                "server:\n  host: 127.0.0.1\n  port: 0\n"
                "probe_interval_s: 3600\n"
            )
            blob = tmp_path / "origin.bin"
            blob.write_bytes(os.urandom(300_000))
            out1 = str(tmp_path / "out1.bin")
            r = subprocess.run(
                [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfget",
                 f"file://{blob}", "-O", out1, "--daemon",
                 "--scheduler", sched_url, "--config", str(daemon_cfg),
                 "--piece-size", str(64 * 1024)],
                capture_output=True, text=True, env=env, timeout=60,
            )
            assert r.returncode == 0, r.stderr
            assert "through daemon" in r.stdout
            with open(out1, "rb") as f:
                assert f.read() == blob.read_bytes()
            state = json.loads((tmp_path / "daemon.json").read_text())
            daemon_pid = state["pid"]
            # Second dfget: reuses the running daemon (same pid in state).
            out2 = str(tmp_path / "out2.bin")
            r2 = subprocess.run(
                [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfget",
                 f"file://{blob}", "-O", out2, "--daemon",
                 "--piece-size", str(64 * 1024)],
                capture_output=True, text=True, env=env, timeout=60,
            )
            assert r2.returncode == 0, r2.stderr
            assert json.loads(
                (tmp_path / "daemon.json").read_text()
            )["pid"] == daemon_pid
            with open(out2, "rb") as f:
                assert f.read() == blob.read_bytes()
        finally:
            sched.kill()
            # Read the pid HERE as well: a failed assertion above must still
            # kill the daemon dfget spawned.
            try:
                daemon_pid = daemon_pid or json.loads(
                    (tmp_path / "daemon.json").read_text()
                )["pid"]
                os.kill(daemon_pid, 9)
            except (OSError, ValueError, KeyError):
                pass


class TestDebugEndpoint:
    def test_stacks_stats_profile(self):
        from dragonfly2_tpu_torch.utils.debug import DebugServer

        srv = DebugServer()
        srv.serve()
        try:
            with urllib.request.urlopen(srv.url + "/debug/stacks", timeout=5) as r:
                body = r.read().decode()
            assert "MainThread" in body and "---" in body
            with urllib.request.urlopen(srv.url + "/debug/stats", timeout=5) as r:
                stats = json.loads(r.read())
            assert stats["threads"] >= 1 and "gc_counts" in stats
            with urllib.request.urlopen(
                srv.url + "/debug/profile?seconds=0.2", timeout=10
            ) as r:
                assert b"cumulative" in r.read()
        finally:
            srv.stop()


class TestDfgetDaemonRecursive:
    def test_recursive_through_daemon(self, tmp_path):
        """VERDICT r2 next-#10: --daemon --recursive routes a directory
        tree through the daemon control API instead of refusing."""
        env = {
            **os.environ,
            "PYTHONPATH": REPO,
            "DF_DAEMON_STATE": str(tmp_path / "daemon.json"),
        }
        sched_cfg = tmp_path / "sched.yaml"
        sched_cfg.write_text(
            f"storage:\n  dir: {tmp_path}/records\n"
            "server:\n  host: 127.0.0.1\n  port: 0\n"
        )
        launcher = (
            "import sys\n"
            "from dragonfly2_tpu_torch.cli.scheduler import serve\n"
            "from dragonfly2_tpu_torch.config import SchedulerConfigFile, load_config\n"
            "cfg = load_config(SchedulerConfigFile, sys.argv[1])\n"
            "srv = serve(cfg, device='cpu')\n"
            "print('READY', srv.url, flush=True)\n"
            "import time; time.sleep(120)\n"
        )
        sched = subprocess.Popen(
            [sys.executable, "-c", launcher, str(sched_cfg)],
            stdout=subprocess.PIPE, text=True, env=env,
        )
        daemon_pid = None
        try:
            sched_url = _ready_url(sched)
            daemon_cfg = tmp_path / "daemon.yaml"
            daemon_cfg.write_text(
                f"storage:\n  dir: {tmp_path}/dstore\n"
                "server:\n  host: 127.0.0.1\n  port: 0\n"
                "probe_interval_s: 3600\n"
            )
            # A small tree with a nested dir, an empty dir, and an odd name.
            src = tmp_path / "tree"
            (src / "sub").mkdir(parents=True)
            (src / "empty").mkdir()
            (src / "a.bin").write_bytes(os.urandom(150_000))
            (src / "sub" / "b#x.bin").write_bytes(os.urandom(70_000))
            out = str(tmp_path / "restored")
            r = subprocess.run(
                [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfget",
                 f"file://{src}", "-O", out, "--daemon", "--recursive",
                 "--scheduler", sched_url, "--config", str(daemon_cfg),
                 "--piece-size", str(64 * 1024)],
                capture_output=True, text=True, env=env, timeout=90,
            )
            assert r.returncode == 0, r.stderr + r.stdout
            assert "downloaded 2 files through daemon" in r.stdout
            assert (src / "a.bin").read_bytes() == \
                (tmp_path / "restored" / "a.bin").read_bytes()
            assert (src / "sub" / "b#x.bin").read_bytes() == \
                (tmp_path / "restored" / "sub" / "b#x.bin").read_bytes()
            assert (tmp_path / "restored" / "empty").is_dir()
        finally:
            sched.kill()
            # Read the pid HERE: a failed assertion above must still kill
            # the daemon dfget spawned (it registers the state file as
            # soon as it boots).
            try:
                daemon_pid = json.loads(
                    (tmp_path / "daemon.json").read_text()
                )["pid"]
                os.kill(daemon_pid, 15)
            except (OSError, ValueError, KeyError):
                pass


# -- the two packages' control APIs against each other ----------------------


def _jax_swarm(tmp_path):
    """The reference's in-process swarm (Python stores), as ``_Swarm``."""
    from tests.test_daemon import _Swarm as JSwarm

    return JSwarm(tmp_path / "jax")


def _post(url, body: bytes):
    req = urllib.request.Request(url + "/download", data=body,
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_control_api_bodies_equal_the_reference(tmp_path):
    from dragonfly2_tpu.rpc.daemon_control import DaemonControlServer as JDaemonControlServer

    swarms = {"jax": _jax_swarm(tmp_path), "torch": _Swarm(tmp_path / "torch", n_hosts=2)}
    servers = {}
    try:
        for name, swarm in swarms.items():
            swarm.origin.content_length = lambda u: 3 * PIECE
            cls = JDaemonControlServer if name == "jax" else DaemonControlServer
            servers[name] = cls(swarm.daemons[0].conductor, piece_size=PIECE)
            servers[name].serve()
        bodies = {}
        for name, srv in servers.items():
            out = tmp_path / f"{name}.bin"
            got = [
                _post(srv.url, json.dumps({"url": "https://origin/ctl",
                                           "output": str(out)}).encode()),
                _post(srv.url, json.dumps({"url": "https://origin/ctl"}).encode()),
                _post(srv.url, b"{}"),
                _post(srv.url, b"not json"),
            ]
            with urllib.request.urlopen(srv.url + "/healthy", timeout=5) as r:
                got.append((r.status, json.loads(r.read())))
            bodies[name] = got
        assert (tmp_path / "jax.bin").read_bytes() == (tmp_path / "torch.bin").read_bytes()
        for (j_code, j_body), (t_code, t_body) in zip(bodies["jax"], bodies["torch"]):
            assert j_code == t_code
            assert j_body.keys() == t_body.keys()
            # Wall time and the caller's own output path differ by nature.
            assert {k: v for k, v in j_body.items() if k not in ("cost_s", "output")} == \
                {k: v for k, v in t_body.items() if k not in ("cost_s", "output")}
        assert bodies["torch"][0][1]["ok"] and bodies["torch"][0][1]["pieces"] == 3
        assert bodies["torch"][1][1]["ok"] and bodies["torch"][1][1]["pieces"] == 3
        assert bodies["torch"][2][0] == bodies["torch"][3][0] == 400
    finally:
        for srv in servers.values():
            srv.stop()


def test_ensure_daemon_spawns_the_ports_dfdaemon(tmp_path, monkeypatch):
    from dragonfly2_tpu_torch.rpc import daemon_control

    monkeypatch.setenv("DF_DAEMON_STATE", str(tmp_path / "daemon.json"))
    spawned = []

    class FakePopen:
        def __init__(self, argv, **kw):
            spawned.append(argv)
            # What the spawned daemon would do first: publish its control URL.
            write_state("http://127.0.0.1:1")

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    # Healthy once spawned (nothing listens at that URL in this test).
    monkeypatch.setattr(daemon_control, "daemon_healthy",
                        lambda url, timeout=2.0: bool(spawned))
    url = daemon_control.ensure_daemon("http://scheduler:8002",
                                       extra_args=["--config", "d.yaml"], spawn_timeout=5.0)
    assert url == "http://127.0.0.1:1"
    assert spawned == [[sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfdaemon",
                        "--scheduler", "http://scheduler:8002", "--config", "d.yaml"]]
