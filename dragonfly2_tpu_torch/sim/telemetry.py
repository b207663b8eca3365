"""Telemetry-plane chaos drills (DESIGN.md §23).

Two drills, both runnable standalone (``python -m
dragonfly2_tpu_torch.sim.telemetry``) and driven by
tests/test_torch_telemetry_drills.py:

**Kill drill** — N subprocess "daemons" run a synthetic piece-fetch
storm through the REAL telemetry write path: seeded latencies feed
``PieceLatencyTracker.observe`` (the conductor's hot-path sample point →
the ``daemon_piece_fetch_seconds`` sketch) and a REAL ``MetricJournal``
snapshots the default registry.  One child carries a ``crash``
FaultSpec on the ``metrics.journal.write`` seam and SIGKILLs itself at a
deterministic journal write, mid-storm.  The drill then tears the dead
child's tail frame (the mid-``os.write`` power-cut signature a
seam-placed kill cannot produce byte-exactly) and flips one payload
byte in a survivor's mid-file frame (bit rot).  ``fleet_assemble`` must
still produce fleet p50/p99: torn tail tolerated, the digest-bad frame
counted but NEVER admitted, and — because every child also appends each
raw sample to a sidecar before observing it — the merged sketch
quantiles are checked against an EXACT oracle computed from precisely
the samples the admitted frames cover.

**Burn-rate drill** — a latency SLO over a synthetic fetch sketch runs
healthy → overloaded → recovered phases against a live ``SLOEngine``
while a ``MetricJournal`` snapshots alongside every tick.  The alert
must fire within one fast window of the overload, clear after recovery,
and the journal replay (``slo.replay_fleet``) must reconstruct the same
state ``/debug/slo`` served live.

Port of ``dragonfly2_tpu/sim/telemetry.py``, with the logic verbatim.
The kill drill's children run this module (``python -m
dragonfly2_tpu_torch.sim.telemetry --child``) from the directory that
holds the package, with no JAX variable in their environment, and the
fleet view comes from the port's own ``bench/fleet_assemble.py``.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

# The directory that holds the package: the children's working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DRILL_SLO = {
    "name": "drill_fetch_p95",
    "objective": "latency",
    "metric": "drill_fetch_seconds",
    "threshold_ms": 100.0,
    "target": 0.95,
    "fast_window_s": 0.6,
    "slow_window_s": 2.4,
    "burn_threshold": 2.0,
}


# ---------------------------------------------------------------------------
# Child body (the kill drill's subprocess workload)
# ---------------------------------------------------------------------------


def child_main(argv: List[str]) -> int:
    """Synthetic daemon: seeded fetch latencies through the real
    tracker → sketch → journal path.  Raw samples are appended (one
    O_APPEND write per line, BEFORE the observe) to a sidecar the parent
    uses as the exact oracle."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--journal", required=True)
    p.add_argument("--raw", required=True)
    p.add_argument("--service", default="dfdaemon")
    p.add_argument("--samples", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snapshot-every", type=int, default=50)
    args = p.parse_args(argv)

    from ..utils import faultinject

    faultinject.install_from_env()

    import random

    from ..daemon.piece_pipeline import PieceLatencyTracker
    from ..utils.metric_journal import MetricJournal

    tracker = PieceLatencyTracker()
    journal = MetricJournal(
        args.journal, service=args.service, interval_s=3600.0,
        run_id=f"run-{args.service}-{args.seed}",
    )
    rng = random.Random(args.seed)
    raw_fd = os.open(args.raw, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    for i in range(args.samples):
        latency = rng.lognormvariate(-3.5, 1.0)
        # Raw sample durable BEFORE the observe: the oracle prefix per
        # admitted snapshot is then exact by construction.
        os.write(raw_fd, f"{latency!r}\n".encode())
        tracker.observe(latency)
        if (i + 1) % args.snapshot_every == 0:
            journal.write_snapshot()
    journal.close()
    os.close(raw_fd)
    print(json.dumps({"ok": True, "samples": args.samples}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Kill drill
# ---------------------------------------------------------------------------


def run_kill_drill(
    workdir: str,
    *,
    n_children: int = 3,
    samples: int = 400,
    snapshot_every: int = 50,
    kill_at_write: int = 4,
) -> Dict[str, Any]:
    """SIGKILL one of ``n_children`` mid-storm; assemble the fleet view
    from the survivors plus the dead child's torn journal.  Returns the
    drill report (asserted by tests, rendered into TELEMETRY_r*.json)."""
    os.makedirs(workdir, exist_ok=True)
    procs = []
    journals: List[str] = []
    raws: List[str] = []
    for i in range(n_children):
        journal = os.path.join(workdir, f"daemon{i}.dfmj")
        raw = os.path.join(workdir, f"daemon{i}.raw")
        journals.append(journal)
        raws.append(raw)
        env = dict(os.environ)
        if i == 0:
            # The victim: crash (self-SIGKILL) at its Nth journal write.
            env["DF_FAULTINJECT"] = json.dumps({
                "seed": 0,
                "faults": [{
                    "site": "metrics.journal.write", "kind": "crash",
                    "at": [kill_at_write - 1],
                }],
            })
        procs.append(subprocess.Popen(
            [
                sys.executable, "-m", "dragonfly2_tpu_torch.sim.telemetry",
                "--child",
                "--journal", journal, "--raw", raw,
                "--service", f"dfdaemon{i}",
                "--samples", str(samples), "--seed", str(100 + i),
                "--snapshot-every", str(snapshot_every),
            ],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=_ROOT,
        ))
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        outs.append((proc.returncode, out, err))
    if outs[0][0] != -signal.SIGKILL:
        raise AssertionError(
            f"victim was not SIGKILLed: rc={outs[0][0]} "
            f"out={outs[0][1]!r} err={outs[0][2]!r}"
        )
    for rc, out, err in outs[1:]:
        if rc != 0:
            raise AssertionError(f"survivor failed: {rc} {out!r} {err!r}")

    # The kill left the victim's journal ending at a frame boundary (the
    # crash seam fires before the write).  Tear its tail frame partially
    # — the byte-exact signature of a SIGKILL landing mid-os.write —
    # and flip one payload byte in a survivor's FIRST frame (bit rot);
    # its final cumulative frame is untouched, so the merge loses
    # nothing while the digest check must reject the doctored frame.
    with open(journals[0], "rb") as f:
        victim = f.read()
    assert len(victim) > 40, "victim journal unexpectedly empty"
    with open(journals[0], "wb") as f:
        f.write(victim[:-17])
    with open(journals[1], "rb") as f:
        surv = bytearray(f.read())
    first_payload = surv.find(b'"v"')
    assert first_payload > 0
    surv[first_payload + 1] ^= 0x01
    with open(journals[1], "wb") as f:
        f.write(surv)

    from ..bench.fleet_assemble import build_report

    report = build_report(journals)

    # -- acceptance: journal-level invariants --------------------------------
    stats = {s["path"]: s for s in report["journals"]}
    if not stats[journals[0]]["torn_tail"]:
        raise AssertionError("victim journal's torn tail not detected")
    if stats[journals[1]]["corrupt"] != 1:
        raise AssertionError("doctored survivor frame not rejected")
    if stats[journals[0]]["corrupt"] != 0:
        raise AssertionError("torn tail must not count as corrupt")
    if len(report["runs"]) != n_children:
        raise AssertionError(f"expected {n_children} runs: {report['runs']}")

    # -- acceptance: merged quantiles vs the exact oracle --------------------
    from ..utils.metric_journal import (
        final_snapshots_by_run,
        replay_metric_journal,
    )

    oracle: List[float] = []
    per_run_counts: Dict[str, int] = {}
    for i, (journal, raw) in enumerate(zip(journals, raws)):
        snaps, _ = replay_metric_journal(journal)
        finals = final_snapshots_by_run(snaps)
        covered = 0
        for snap in finals.values():
            state = snap["metrics"].get("daemon_piece_fetch_seconds")
            if state:
                covered += int(sum(
                    st["total"] for _k, st in state["series"]
                ))
        per_run_counts[f"dfdaemon{i}"] = covered
        with open(raw) as f:
            all_samples = [float(line) for line in f if line.strip()]
        # Cumulative snapshots cover a PREFIX of the raw sample stream.
        oracle.extend(all_samples[:covered])

    fleet = report["quantiles"]["daemon_piece_fetch_seconds"]
    if int(fleet["count"]) != len(oracle):
        raise AssertionError(
            f"merged sketch count {fleet['count']} != oracle {len(oracle)} "
            "— a torn/corrupt frame leaked into the merge"
        )
    oracle.sort()
    alpha = fleet["alpha"]
    checks = {}
    for q in (0.5, 0.99):
        rank = max(int(math.ceil(q * len(oracle))), 1) - 1
        exact = oracle[rank]
        est = fleet[f"p{q * 100:g}"]
        rel = abs(est - exact) / exact
        checks[f"p{q * 100:g}"] = {
            "exact": exact, "estimate": est, "rel_error": rel,
        }
        if rel > alpha * 1.0001 + 1e-12:
            raise AssertionError(
                f"fleet p{q * 100:g} outside the declared bound: "
                f"{est} vs exact {exact} (rel {rel:.5f} > α={alpha})"
            )
    return {
        "ok": True,
        "children": n_children,
        "victim_sigkilled": True,
        "frames_admitted": report["total_frames"],
        "corrupt_rejected": report["total_corrupt"],
        "torn_tail_tolerated": True,
        "oracle_samples": len(oracle),
        "per_run_covered": per_run_counts,
        "alpha": alpha,
        "quantile_checks": checks,
    }


# ---------------------------------------------------------------------------
# Burn-rate drill
# ---------------------------------------------------------------------------


def run_burnrate_drill(
    journal_path: Optional[str] = None,
    *,
    slo: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Synthetic overload: the alert must fire within one fast window,
    clear after recovery, and the journal replay must reconstruct the
    live ``/debug/slo`` state."""
    import tempfile

    from ..utils.metric_journal import MetricJournal, replay_metric_journal
    from ..utils.metrics import Registry
    from ..utils.slo import SLOEngine, replay_fleet

    slo = dict(slo or DRILL_SLO)
    fast = slo["fast_window_s"]
    reg = Registry()
    sketch = reg.sketch(slo["metric"], "drill fetch latency")
    engine = SLOEngine([slo], registry=reg)
    owns_tmp = journal_path is None
    if owns_tmp:
        fd, journal_path = tempfile.mkstemp(suffix=".dfmj")
        os.close(fd)
        os.unlink(journal_path)
    journal = MetricJournal(
        journal_path, registry=reg, service="drill", interval_s=3600.0,
    )

    good_lat = slo["threshold_ms"] / 1e3 * 0.1
    bad_lat = slo["threshold_ms"] / 1e3 * 4.0

    def step(latency: float) -> Dict[str, Any]:
        for _ in range(5):
            sketch.observe(latency)
        state = engine.tick()[slo["name"]]
        journal.write_snapshot()
        time.sleep(0.02)
        return state

    fired_ts = None

    report: Dict[str, Any] = {"ok": True, "slo": slo}
    try:
        # Healthy phase: a full slow window of good traffic.
        deadline = time.monotonic() + slo["slow_window_s"]
        while time.monotonic() < deadline:
            state = step(good_lat)
        if state["breached"]:
            raise AssertionError(f"breached while healthy: {state}")

        # Overload: must flip within ONE fast window (+ scheduling slack).
        t_overload = time.monotonic()
        fired_after = None
        deadline = t_overload + fast * 1.5
        while time.monotonic() < deadline:
            state = step(bad_lat)
            if state["breached"]:
                fired_after = time.monotonic() - t_overload
                fired_ts = time.time()
                break
        if fired_after is None:
            raise AssertionError(
                f"alert did not fire within {fast * 1.5:.1f}s: {state}"
            )
        report["fired_after_s"] = round(fired_after, 3)
        report["fired_within_fast_window"] = fired_after <= fast * 1.25

        # Recovery: good traffic again; must clear.
        t_recover = time.monotonic()
        cleared_after = None
        deadline = t_recover + slo["slow_window_s"] * 2
        while time.monotonic() < deadline:
            state = step(good_lat)
            if not state["breached"]:
                cleared_after = time.monotonic() - t_recover
                break
        if cleared_after is None:
            raise AssertionError("alert never cleared after recovery")
        report["cleared_after_s"] = round(cleared_after, 3)

        # Settle: one more fast window of good traffic so the final
        # burn rates sit away from the threshold boundary (the
        # live-vs-replay comparison is then tight, not boundary-racy).
        deadline = time.monotonic() + fast * 1.2
        while time.monotonic() < deadline:
            step(good_lat)

        # Live /debug/slo state vs journal-replay reconstruction —
        # at the end AND at the moment the alert fired.
        live = engine.state()["slos"][0]
        journal.close()
        snaps, stats = replay_metric_journal(journal_path)
        if stats["corrupt"]:
            raise AssertionError(f"journal corrupt frames: {stats}")
        replayed = replay_fleet(snaps, [slo]).state()["slos"][0]
        if replayed["breached"] != live["breached"]:
            raise AssertionError(
                f"replay disagrees with live: {replayed} vs {live}"
            )
        drift = abs(
            replayed["burn_rate_fast"] - live["burn_rate_fast"]
        )
        if drift > 0.25:
            raise AssertionError(
                f"replay burn rate drifted from live: {drift}"
            )
        at_fire = replay_fleet(
            [s for s in snaps if s["ts"] <= fired_ts + 1e-6], [slo]
        ).state()["slos"][0]
        if not at_fire["breached"]:
            raise AssertionError(
                f"replay at fire time not breached: {at_fire}"
            )
        report["replay_matches_live"] = True
        report["replay_breached_at_fire"] = True
        report["replay_burn_drift"] = round(drift, 6)
        report["journal_frames"] = stats["frames"]
        report["final_state"] = {
            "live": {k: live[k] for k in
                     ("breached", "burn_rate_fast", "burn_rate_slow")},
            "replay": {k: replayed[k] for k in
                       ("breached", "burn_rate_fast", "burn_rate_slow")},
        }
    finally:
        journal.close()
        engine.close()
        if owns_tmp:
            try:
                os.unlink(journal_path)
            except OSError:
                pass
    return report


# ---------------------------------------------------------------------------
# Entry point: full drill round → one TELEMETRY JSON line/file
# ---------------------------------------------------------------------------


def run_round(workdir: str) -> Dict[str, Any]:
    kill = run_kill_drill(os.path.join(workdir, "kill"))
    burn = run_burnrate_drill(os.path.join(workdir, "burn.dfmj"))
    return {
        "ok": kill["ok"] and burn["ok"],
        "metric": "fleet_telemetry_drills",
        "sketch_alpha": kill["alpha"],
        "kill_drill": kill,
        "burnrate_drill": burn,
    }


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--child":
        return child_main(argv[1:])
    import argparse
    import tempfile

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, metavar="FILE",
                   help="write the drill round JSON here (TELEMETRY_r*.json)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as workdir:
        try:
            round_data = run_round(workdir)
        except Exception as exc:  # noqa: BLE001 — one parseable line
            round_data = {
                "ok": False,
                "metric": "fleet_telemetry_drills",
                "error": f"{type(exc).__name__}: {exc}"[:300],
            }
    text = json.dumps(round_data, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if round_data.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
