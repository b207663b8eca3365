"""Port parity: the telemetry-plane drills, ``sim/telemetry.py``, and the
fleet view, ``bench/fleet_assemble.py``.

The port's counterparts of ``tests/test_telemetry_chaos.py``'s four tests,
with the reference's assertions: the kill drill (three journaling
children, one SIGKILLed at its 4th journal write through
``DF_FAULTINJECT``, a torn tail and a bit-rotted frame, fleet quantiles
against an exact oracle), the fleet report's CLI with an SLO replay, the
burn-rate drill (fire within one fast window, clear, replay equals live)
and ``/debug/slo`` serving the engine's state.  Then each package's
``fleet_assemble.build_report`` reads the other package's kill-drill
journals to the same quantiles and the same torn and corrupt counts: the
DFMJ1 frames are one format.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from dragonfly2_tpu.sim import telemetry as j_telemetry
from dragonfly2_tpu_torch.sim import telemetry

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture(scope="module")
def port_kill(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("port_kill")
    return workdir, telemetry.run_kill_drill(str(workdir))


class TestTelemetryKillDrill:
    def test_sigkill_mid_storm_fleet_quantiles_survive(self, port_kill):
        _, report = port_kill
        assert report["ok"] is True
        assert report["children"] == 3
        assert report["victim_sigkilled"] is True
        assert report["corrupt_rejected"] == 1
        assert report["torn_tail_tolerated"] is True
        covered = report["per_run_covered"]
        assert covered["dfdaemon0"] < covered["dfdaemon1"]
        for q, chk in report["quantile_checks"].items():
            assert chk["rel_error"] <= report["alpha"] * 1.0001, (q, chk)

    def test_fleet_assemble_renders_and_reports_slo(self, tmp_path):
        """The CLI surface over a journal set: human rendering + JSON +
        SLO replay through --slo-config."""
        from dragonfly2_tpu_torch.utils.metric_journal import MetricJournal
        from dragonfly2_tpu_torch.utils.metrics import Registry

        journals = []
        for i in range(2):
            reg = Registry()
            sk = reg.sketch("drill_fetch_seconds", "")
            c = reg.counter("drill_ops_total", "")
            path = str(tmp_path / f"p{i}.dfmj")
            j = MetricJournal(path, registry=reg, service=f"d{i}",
                              interval_s=60, run_id=f"run-{i}")
            for k in range(100):
                sk.observe(0.01 if k % 10 else 0.5)
                c.inc()
            j.close()
            journals.append(path)
        slo_cfg = tmp_path / "slos.json"
        slo_cfg.write_text(json.dumps([telemetry.DRILL_SLO]))
        cli = [sys.executable, "-m", "dragonfly2_tpu_torch.bench.fleet_assemble"]
        out = subprocess.run(
            [*cli, *journals, "--json", "--slo-config", str(slo_cfg)],
            capture_output=True, text=True, cwd=str(REPO), timeout=60,
        )
        assert out.returncode == 0, out.stderr
        report = json.loads(out.stdout)
        assert report["total_corrupt"] == 0
        assert len(report["runs"]) == 2
        assert report["counters"]["drill_ops_total"]["total"] == 200.0
        q = report["quantiles"]["drill_fetch_seconds"]
        assert q["count"] == 200
        assert q["p50"] is not None and q["p99"] is not None
        assert report["slos"][0]["name"] == telemetry.DRILL_SLO["name"]
        out2 = subprocess.run(
            [*cli, *journals], capture_output=True, text=True, cwd=str(REPO), timeout=60,
        )
        assert out2.returncode == 0, out2.stderr
        assert "Fleet quantiles" in out2.stdout
        assert "2 run(s) merged" in out2.stdout


class TestBurnRateDrill:
    def test_overload_fires_and_clears_and_replays(self, tmp_path):
        report = telemetry.run_burnrate_drill(str(tmp_path / "burn.dfmj"))
        assert report["ok"] is True
        assert report["fired_within_fast_window"] is True
        assert report["replay_matches_live"] is True
        assert report["replay_breached_at_fire"] is True
        assert report["replay_burn_drift"] <= 0.25
        final = report["final_state"]
        assert final["live"]["breached"] == final["replay"]["breached"]

    def test_debug_slo_endpoint_matches_engine_during_drill(self):
        """/debug/slo serves the installed engine's state verbatim."""
        import urllib.request

        from dragonfly2_tpu_torch.utils import slo as slo_mod
        from dragonfly2_tpu_torch.utils.diagnostics import DiagnosticsServer
        from dragonfly2_tpu_torch.utils.metrics import Registry
        from dragonfly2_tpu_torch.utils.slo import SLOEngine

        reg = Registry()
        sk = reg.sketch("drill_fetch_seconds", "")
        eng = SLOEngine([telemetry.DRILL_SLO], registry=reg)
        for _ in range(50):
            sk.observe(0.01)
        eng.tick(now=0.0)
        for _ in range(50):
            sk.observe(0.5)
        eng.tick(now=0.3)
        slo_mod.install_engine(eng)
        srv = DiagnosticsServer(port=0)
        srv.serve()
        try:
            with urllib.request.urlopen(
                srv.url + "/debug/slo", timeout=5
            ) as r:
                payload = json.loads(r.read())
        finally:
            srv.stop()
            slo_mod.install_engine(None)
            eng.close()
        assert payload["slos"] == eng.state()["slos"]
        assert payload["slos"][0]["breached"] is True


def _journals(workdir):
    return [str(Path(workdir) / f"daemon{i}.dfmj") for i in range(3)]


def _view(report):
    return {
        "quantiles": report["quantiles"],
        "frames": report["total_frames"],
        "corrupt": report["total_corrupt"],
        "journals": [(Path(j["path"]).name, j["frames"], j["corrupt"], j["torn_tail"])
                     for j in report["journals"]],
        "runs": [(r["service"], r["run_id"], r["last_seq"]) for r in report["runs"]],
    }


def test_each_fleet_assemble_reads_the_others_drill_journals(port_kill, tmp_path):
    from dragonfly2_tpu_torch.bench import fleet_assemble as t_fa
    from tools import fleet_assemble as j_fa

    port_dir, _ = port_kill
    ref_dir = tmp_path / "ref_kill"
    assert j_telemetry.run_kill_drill(str(ref_dir))["ok"] is True
    for workdir in (port_dir, ref_dir):
        paths = _journals(workdir)
        port_view = _view(t_fa.build_report(paths))
        ref_view = _view(j_fa.build_report(paths))
        assert port_view == ref_view
        assert port_view["corrupt"] == 1
        assert [j[3] for j in port_view["journals"]] == [True, False, False]
        assert port_view["quantiles"]["daemon_piece_fetch_seconds"]["count"] > 0
