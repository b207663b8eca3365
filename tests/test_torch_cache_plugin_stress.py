"""Port parity: the last small modules, ``dragonfly2_tpu_torch/utils/
{cache,plugin}.py``, ``version.py`` and ``tools/stress.py``, against the
reference's, on the same inputs.

- ``TTLCache``: the reference's four cases (``tests/test_utils.py``), each
  run on both packages with one fake clock, and the two caches' answers
  equal at every step.
- The plugin loader: one plugin directory loads in both packages, lists
  the same entries, and both refuse a missing plugin and a file without a
  factory (``tests/test_breadth.py``).
- ``build_info``: the same keys and the same commit and platform.
- The stress tool: ``run_stress`` over each package's in-process swarm
  (the same URLs, 20 downloads, 4 workers) succeeds everywhere, and the
  nearest-rank percentiles and the empty-URL refusal agree; then the
  binary, ``python -m dragonfly2_tpu_torch.tools.stress``, drives the
  port's daemon parts against a port scheduler in serve mode.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from dragonfly2_tpu.utils import cache as jcache
from dragonfly2_tpu.utils import plugin as jplugin
from dragonfly2_tpu_torch.utils import cache as tcache
from dragonfly2_tpu_torch.utils import plugin as tplugin

REPO = Path(__file__).resolve().parents[1]
CACHES = {"jax": jcache, "torch": tcache}
PLUGINS = {"jax": jplugin, "torch": tplugin}


def _pair(**kw):
    t = [0.0]
    return t, [m.TTLCache(clock=lambda: t[0], **kw) for m in (jcache, tcache)]


class TestTTLCache:
    def test_set_get_expire(self):
        t, caches = _pair(default_ttl=10.0)
        for c in caches:
            c.set("k", "v")
            c.set("short", 1, ttl=2.0)
            c.set("forever", 2, ttl=tcache.NO_EXPIRATION)
        assert [c.get("k") for c in caches] == ["v", "v"]
        t[0] = 3.0
        assert [c.get("short") for c in caches] == [None, None]
        t[0] = 11.0
        assert [(c.get("k"), c.get("forever"), len(c)) for c in caches] == [(None, 2, 1)] * 2

    def test_add_only_if_absent(self):
        t, caches = _pair(default_ttl=5.0)
        for c in caches:
            assert c.add("k", 1)
            assert not c.add("k", 2)
            assert c.get("k") == 1
        t[0] = 6.0
        assert [c.add("k", 3) for c in caches] == [True, True]
        assert [c.get("k") for c in caches] == [3, 3]

    def test_scan(self):
        _t, caches = _pair()
        found = []
        for c in caches:
            c.set("networktopology:a:b", 1)
            c.set("networktopology:a:c", 2)
            c.set("other", 3)
            found.append(dict(c.scan(r"^networktopology:a:")))
        assert found[0] == found[1] == {"networktopology:a:b": 1, "networktopology:a:c": 2}

    def test_purge(self):
        t, caches = _pair(default_ttl=5.0)
        for c in caches:
            for i in range(10):
                c.set(str(i), i, ttl=None if i < 7 else 20.0)
        t[0] = 6.0
        assert [c.purge_expired() for c in caches] == [7, 7]
        assert [sorted(c.keys()) for c in caches] == [["7", "8", "9"]] * 2
        for c in caches:
            c.clear()
            c.close()
        assert [len(c) for c in caches] == [0, 0]


PLUGIN_SRC = (
    "def create_plugin(weight=1.0):\n"
    "    class Eval:\n"
    "        def evaluate_parents(self, parents, child, total):\n"
    "            return sorted(parents, key=lambda p: p.id)\n"
    "        w = weight\n"
    "    return Eval()\n"
)


class TestPlugins:
    def test_load_and_list(self, tmp_path):
        assert tplugin.plugin_filename("evaluator", "myeval") == \
            jplugin.plugin_filename("evaluator", "myeval")
        (tmp_path / tplugin.plugin_filename("evaluator", "myeval")).write_text(PLUGIN_SRC)
        (tmp_path / "unrelated.py").write_text("x = 1\n")
        for name, mod in PLUGINS.items():
            plug = mod.load_plugin(str(tmp_path), "evaluator", "myeval", weight=2.5)
            assert plug.w == 2.5, name
            assert mod.list_plugins(str(tmp_path)) == [
                {"type": "evaluator", "name": "myeval",
                 "file": mod.plugin_filename("evaluator", "myeval")}]
            with pytest.raises(mod.PluginError):
                mod.load_plugin(str(tmp_path), "evaluator", "missing")
        assert tplugin.list_plugins(str(tmp_path / "absent")) == []

    def test_factory_required(self, tmp_path):
        (tmp_path / tplugin.plugin_filename("searcher", "bad")).write_text("x = 1\n")
        (tmp_path / tplugin.plugin_filename("searcher", "broken")).write_text("1/0\n")
        for mod in PLUGINS.values():
            with pytest.raises(mod.PluginError, match="create_plugin"):
                mod.load_plugin(str(tmp_path), "searcher", "bad")
            with pytest.raises(mod.PluginError, match="import failed"):
                mod.load_plugin(str(tmp_path), "searcher", "broken")


def test_version_metadata():
    from dragonfly2_tpu.version import build_info as jinfo
    from dragonfly2_tpu_torch.version import build_info as tinfo

    info, ref = tinfo(), jinfo()
    assert info.version and info.python_version
    assert "/" in info.platform
    assert set(info.to_dict()) == {"version", "git_commit", "python_version", "platform"}
    assert (info.git_commit, info.python_version, info.platform) == \
        (ref.git_commit, ref.python_version, ref.platform)


class TestStress:
    def test_stress_tool_over_swarm(self, tmp_path):
        from dragonfly2_tpu.tools.stress import run_stress as jrun
        from dragonfly2_tpu_torch.tools.stress import run_stress as trun
        from tests.test_daemon import _Swarm as JSwarm
        from tests.test_torch_daemon import PIECE, _Swarm as TSwarm

        urls = [f"https://origin/stress-{t}" for t in range(3)]
        summaries, payloads = {}, {}
        for name, swarm_cls, run in (("jax", JSwarm, jrun), ("torch", TSwarm, trun)):
            swarm = swarm_cls(tmp_path / name, n_hosts=3)
            for u in urls:
                swarm.daemons[0].download(u, piece_size=PIECE, content_length=2 * PIECE)
            got = []

            def dl(url, swarm=swarm, got=got):
                result = swarm.daemons[1].download(url, piece_size=PIECE)
                got.append((url, result.bytes))
                return result

            summaries[name] = run(dl, urls, concurrency=4, total=20).summary()
            payloads[name] = sorted(got)
        for s in summaries.values():
            assert s["total"] == s["succeeded"] == 20 and s["failed"] == 0
            assert s["throughput_MBps"] > 0 and s["latency_p95_ms"] > 0
        assert payloads["jax"] == payloads["torch"]
        assert set(summaries["jax"]) == set(summaries["torch"])

    def test_stress_percentile_and_empty_urls(self):
        from dragonfly2_tpu.tools.stress import StressReport as JReport
        from dragonfly2_tpu_torch.tools.stress import StressReport, run_stress

        for cls in (JReport, StressReport):
            r = cls()
            r.latencies_s = [i / 1000 for i in range(1, 101)]
            assert r.percentile(99) == pytest.approx(0.099)
            assert r.percentile(50) == pytest.approx(0.050)
            assert cls().percentile(50) == 0.0
        with pytest.raises(ValueError):
            run_stress(lambda u: None, [], total=5)
        report = run_stress(lambda u: (_ for _ in ()).throw(IOError(u)), ["x"], total=3)
        assert (report.succeeded, report.failed) == (0, 3)

    def test_binary_drives_port_daemons_against_a_port_scheduler(self, tmp_path):
        from dragonfly2_tpu_torch.cli import scheduler as sched_cli
        from dragonfly2_tpu_torch.config import SchedulerConfigFile

        cfg = SchedulerConfigFile()
        cfg.server.host, cfg.server.port = "127.0.0.1", 0
        cfg.storage.dir = str(tmp_path / "records")
        serving = sched_cli.serve(cfg, device="cpu")
        src = tmp_path / "blob.bin"
        src.write_bytes(bytes(range(256)) * 1024)
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "dragonfly2_tpu_torch.tools.stress",
                 "--scheduler", serving.url, "--url", f"file://{src}",
                 "--total", "6", "--concurrency", "2", "--piece-size", "65536",
                 "--work-dir", str(tmp_path / "work")],
                capture_output=True, text=True, timeout=120, cwd=str(REPO))
        finally:
            serving.stop()
        assert proc.returncode == 0, proc.stderr[-2000:]
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["succeeded"] == 6 and summary["failed"] == 0
        assert summary["throughput_MBps"] > 0
