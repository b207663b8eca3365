"""Port parity: the metric journal and the SLO engine,
``dragonfly2_tpu_torch/utils/{metric_journal,slo}.py`` against
``dragonfly2_tpu/utils/{metric_journal,slo}.py`` (the counterpart of
``TestMetricJournal``, ``TestSLOEngine`` and ``TestTelemetryConfig`` in
``tests/test_telemetry.py``, and of the kill drills of
``tests/test_{telemetry,trace}_chaos.py``).

- The same seeded metric stream gives equal registry snapshots and
  byte-equal ``encode_frame`` frames in both packages.
- Each package replays the other's journal (torn tail, digest-bad frame,
  garbage between frames) and finds the same final snapshot per run.
- ``SLOEngine`` burn rates and breach states are equal on one seeded
  sketch sequence with an injected clock, live (``tick``) and replayed
  (``replay_fleet``), for a latency and an availability objective.
- ``parse_slos`` and the ``telemetry`` config section raise on the same
  inputs with the same messages.
- A child process SIGKILLed at its journal's write seam
  (``DF_FAULTINJECT``) leaves a journal and a durable trace log whose
  whole frames both packages replay, tail torn or not.

Each test restores the SLO engine install and the fault injector.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dragonfly2_tpu.config.schema as jschema
import dragonfly2_tpu.utils.metric_journal as jmj
import dragonfly2_tpu.utils.metrics as jmetrics
import dragonfly2_tpu.utils.slo as jslo
import dragonfly2_tpu.utils.tracing as jtr
import dragonfly2_tpu_torch.config.schema as tschema
import dragonfly2_tpu_torch.utils.metric_journal as tmj
import dragonfly2_tpu_torch.utils.metrics as tmetrics
import dragonfly2_tpu_torch.utils.slo as tslo
import dragonfly2_tpu_torch.utils.tracing as ttr

REPO = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": (jmj, jmetrics, jslo, jtr),
    "torch": (tmj, tmetrics, tslo, ttr),
}


@pytest.fixture(autouse=True)
def _restore_installs():
    engines = (jslo.current_engine(), tslo.current_engine())
    yield
    jslo.install_engine(engines[0])
    tslo.install_engine(engines[1])


def _stream(metrics_mod, seed=0, n=200):
    """A registry fed one seeded stream: a labelled counter, a gauge and
    two sketches."""
    rng = np.random.default_rng(seed)
    reg = metrics_mod.Registry()
    ops = reg.counter("p_ops_total", "ops", ["kind"])
    depth = reg.gauge("p_depth", "depth")
    lat = reg.sketch("p_lat_seconds", "latency")
    lab = reg.sketch("p_flush_seconds", "flush", ["arm"])
    for v, k in zip(rng.lognormal(-5.0, 1.0, n), rng.integers(0, 3, n)):
        ops.inc(kind=f"k{k}")
        lat.observe(float(v))
        lab.observe(float(v) * 2, arm="a" if k else "b")
    depth.set(float(rng.integers(0, 100)))
    return reg


def test_registry_snapshots_and_frames_byte_equal():
    snaps = {name: _stream(m[1]).snapshot() for name, m in PKGS.items()}
    assert snaps["torch"] == snaps["jax"]
    payload = {"v": 1, "service": "s", "run_id": "r", "pid": 1, "seq": 3,
               "ts": 12.5, "metrics": snaps["torch"]}
    assert tmj.encode_frame(payload) == jmj.encode_frame(payload)
    assert tmj.FRAME_MAGIC == jmj.FRAME_MAGIC == b"DFMJ1 "


def _journal(mod_mj, reg, path, run_id, n, ops):
    j = mod_mj.MetricJournal(str(path), registry=reg, service="svc", run_id=run_id,
                             interval_s=3600.0)
    for _ in range(n):
        ops.inc(kind="x")
        j.write_snapshot()
    j.close()  # the final frame
    return j


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_each_package_replays_the_others_journal(tmp_path, writer):
    mj, metrics_mod = PKGS[writer][:2]
    path = tmp_path / "m.dfmj"
    reg = _stream(metrics_mod)
    _journal(mj, reg, path, "run-a", 3, reg.get("p_ops_total"))
    reg2 = metrics_mod.Registry()  # a restart: fresh registry and run id
    _journal(mj, reg2, path, "run-b", 1, reg2.counter("p_ops_total", "ops", ["kind"]))
    data = path.read_bytes()
    got = {}
    for name, (reader, *_rest) in PKGS.items():
        snaps, stats = reader.replay_metric_journal(str(path))
        assert stats == {"frames": 6, "corrupt": 0, "torn_tail": False}
        finals = reader.final_snapshots_by_run(snaps)
        assert set(finals) == {("svc", "run-a"), ("svc", "run-b")}
        got[name] = (snaps, finals)
    assert got["torch"] == got["jax"]
    # Torn tail, a digest-bad frame and garbage between frames.
    second = data.index(b"DFMJ1 ", 1)
    bad = bytearray(data[:-9])
    bad[data.index(b"\n", second) + 3] ^= 0x01
    bad[second:second] = b"#### a log line ####\n"
    path.write_bytes(bytes(bad))
    for reader, *_rest in PKGS.values():
        snaps, stats = reader.replay_metric_journal(str(path))
        assert stats == {"frames": 4, "corrupt": 1, "torn_tail": True}
        assert [s["seq"] for s in snaps] == [1, 3, 4, 1]


def _slos():
    return [
        {"name": "lat", "objective": "latency", "metric": "p_lat_seconds",
         "threshold_ms": 10.0, "target": 0.9, "fast_window_s": 5.0,
         "slow_window_s": 30.0, "burn_threshold": 2.0},
        {"name": "avail", "objective": "availability", "good_metric": "p_good_total",
         "total_metric": "p_all_total", "target": 0.95, "fast_window_s": 5.0,
         "slow_window_s": 30.0},
    ]


def _drive_engine(metrics_mod, slo_mod, seed=3):
    """One seeded stream through a live engine with an injected clock:
    healthy, overloaded, recovered.  → (states per tick, the snapshots a
    journal would have written)."""
    rng = np.random.default_rng(seed)
    reg = metrics_mod.Registry()
    lat = reg.sketch("p_lat_seconds", "latency")
    good = reg.counter("p_good_total", "good")
    total = reg.counter("p_all_total", "all")
    engine = slo_mod.SLOEngine(_slos(), registry=reg)
    states, snaps = [], []
    for t in range(60):
        bad_share = 0.6 if 20 <= t < 35 else 0.02
        for _ in range(20):
            bad = rng.random() < bad_share
            lat.observe(float(rng.uniform(0.02, 0.05) if bad else rng.uniform(0.001, 0.009)))
            total.inc()
            if not bad:
                good.inc()
        states.append(engine.tick(now=1000.0 + t))
        snaps.append({"service": "s", "run_id": "r", "seq": t + 1, "ts": 1000.0 + t,
                      "metrics": reg.snapshot()})
    engine.close()
    return states, snaps


def test_slo_engine_states_equal_live_and_replayed():
    live = {name: _drive_engine(m[1], m[2]) for name, m in PKGS.items()}
    (j_states, j_snaps), (t_states, t_snaps) = live["jax"], live["torch"]
    assert t_states == j_states
    breached = [s["lat"]["breached"] for s in t_states]
    assert any(breached) and not breached[-1] and not breached[0]
    assert any(s["avail"]["breached"] for s in t_states)
    # Replay of the journal stream, across the packages both ways.
    for mod_a, snaps in ((tslo, j_snaps), (jslo, t_snaps), (tslo, t_snaps)):
        engine = mod_a.replay_fleet(snaps, _slos())
        assert engine.state() == jslo.replay_fleet(j_snaps, _slos()).state()
    # The breach gauges on each package's default registry agree.
    for name in ("lat", "avail"):
        assert (tslo.SLO_BREACHED.value(slo=name)
                == float(t_states[-1][name]["breached"]))


BAD_SLOS = [
    [{"name": "", "objective": "latency", "metric": "m", "threshold_ms": 1, "target": 0.9}],
    [{"name": "x", "objective": "nope", "target": 0.9}],
    [{"name": "x", "objective": "latency", "metric": "m", "threshold_ms": 1, "target": 1.0}],
    [{"name": "x", "objective": "latency", "metric": "", "threshold_ms": 1, "target": 0.9}],
    [{"name": "x", "objective": "latency", "metric": "m", "threshold_ms": 0, "target": 0.9}],
    [{"name": "x", "objective": "availability", "good_metric": "g", "target": 0.9}],
    [{"name": "x", "objective": "latency", "metric": "m", "threshold_ms": 1, "target": 0.9,
      "fast_window_s": 60.0, "slow_window_s": 30.0}],
    [{"name": "x", "objective": "latency", "metric": "m", "threshold_ms": 1, "target": 0.9,
      "burn_threshold": 0}],
    [{"name": "x", "objective": "latency", "metric": "m", "threshold_ms": 1, "target": 0.9,
      "extra": 1}],
    [{"name": "x", "objective": "latency", "metric": "m", "threshold_ms": 1, "target": 0.9}] * 2,
]


@pytest.mark.parametrize("raw", BAD_SLOS)
def test_parse_slos_and_the_config_section_raise_alike(raw):
    messages = []
    for slo_mod in (jslo, tslo):
        with pytest.raises(ValueError) as exc:
            slo_mod.parse_slos(raw)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    messages = []
    for schema in (jschema, tschema):
        cfg = schema.SchedulerConfigFile()
        cfg.telemetry.slos = raw
        with pytest.raises(schema.ConfigError, match="telemetry.slos") as exc:
            cfg.validate()
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_good_slos_parse_alike():
    j = jslo.parse_slos(_slos())
    t = tslo.parse_slos(_slos())
    assert [vars(s) for s in t] == [vars(s) for s in j]
    for schema in (jschema, tschema):
        cfg = schema.SchedulerConfigFile()
        cfg.telemetry.slos = _slos()
        cfg.validate()


_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from dragonfly2_tpu_torch.utils import faultinject, metric_journal, metrics, tracing

faultinject.install_from_env()
journal_path, trace_path = sys.argv[2], sys.argv[3]
tracing.default_tracer.exporter = tracing.DurableSpanExporter(
    trace_path, service="child", sample_rate=1.0)
reg = metrics.Registry()
lat = reg.sketch("c_lat_seconds", "latency")
journal = metric_journal.MetricJournal(journal_path, registry=reg, service="child",
                                       interval_s=3600.0)
for i in range(100):
    with tracing.default_tracer.span("child/step", i=i):
        lat.observe(0.001 * (i + 1))
    print(i, flush=True)
    journal.write_snapshot()
"""


def test_sigkilled_childs_journal_and_trace_log_replay_whole_frames(tmp_path):
    journal, trace = tmp_path / "child.dfmj", tmp_path / "child.dftrace"
    env = dict(os.environ)
    env["DF_FAULTINJECT"] = json.dumps(
        {"seed": 0, "faults": [{"site": "metrics.journal.write", "kind": "crash", "at": [7]}]})
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(REPO), str(journal), str(trace)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    steps = [int(x) for x in proc.stdout.split()]
    assert steps == list(range(8))  # the 8th write died before its frame
    for torn in (False, True):
        if torn:
            for path in (journal, trace):
                path.write_bytes(path.read_bytes()[:-11])
        got = {}
        for name, (mj, _m, _s, tr) in PKGS.items():
            snaps, jstats = mj.replay_metric_journal(str(journal))
            reqs, tstats = tr.replay_trace_log(str(trace))
            assert jstats == {"frames": 7 - torn, "corrupt": 0, "torn_tail": torn}
            assert tstats == {"frames": 8 - torn, "corrupt": 0, "torn_tail": torn}
            assert [s["seq"] for s in snaps] == list(range(1, 8 - torn))
            counts = [s["metrics"]["c_lat_seconds"]["series"][0][1]["total"] for s in snaps]
            assert counts == list(range(1, 8 - torn))
            got[name] = (snaps, [s["attributes"] for s in tr.log_spans(reqs)])
        assert got["torch"] == got["jax"]
