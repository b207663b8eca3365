"""Merge per-process metric journals into fleet-wide telemetry.

Every plane appends crash-safe DFMJ1 snapshot frames to its own metric
journal (``--metric-journal`` / config ``telemetry.journal_path`` —
utils/metric_journal.py).  This tool is the metric twin of
``bench/trace_assemble.py``: it replays N processes' journals (torn
tails tolerated, digest-bad frames NEVER admitted) and answers the
operator's question the per-process ``/metrics`` scrape cannot — *what
is the swarm-wide piece-fetch p99 right now, and is it burning the SLO?*

  python -m dragonfly2_tpu_torch.bench.fleet_assemble JOURNAL [JOURNAL ...]
      [--json]                  # machine-readable full report
      [--quantiles 0.5,0.9,0.99]
      [--slo-config FILE]       # JSON list of SLO declarations
                                # (config telemetry.slos entries) to
                                # evaluate over the merged replay

Merge semantics (DESIGN.md §23):

- **sketches merge losslessly** — bucket counts add exactly, so the
  fleet quantile equals the quantile of one sketch that observed every
  process's samples (within the declared relative-error bound α);
- **counters sum with restart/reset detection via run identity** —
  snapshots are cumulative per ``run_id``, so each run contributes its
  final admitted value exactly once, and a restarted process (fresh
  run_id) starts a new summand instead of being mistaken for a reset;
- **gauges stay per-run** — summing them is meaningless, so the report
  lists each run's final value;
- **SLOs replay** — with ``--slo-config``, the merged snapshot streams
  rebuild the fleet-cumulative (good, total) series and the burn-rate
  engine evaluates it exactly as a live fleet engine would
  (utils/slo.py replay_fleet).

Port of ``tools/fleet_assemble.py``, with the logic verbatim, reading the
port's ``utils/metric_journal`` and ``utils/metrics``.  The DFMJ1 frames
are the reference's, so either package's copy reads the other's journals.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


def _label_str(label_names: List[str], key: List[str]) -> str:
    if not key:
        return "{}"
    inner = ",".join(f'{n}="{v}"' for n, v in zip(label_names, key))
    return "{" + inner + "}"


def load_journals(
    paths: List[str],
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Replay every journal → (all admitted snapshots, per-journal stats)."""
    from ..utils.metric_journal import replay_metric_journal

    snapshots: List[Dict[str, Any]] = []
    stats: List[Dict[str, Any]] = []
    for path in paths:
        snaps, st = replay_metric_journal(path)
        st = dict(
            st,
            path=str(path),
            services=sorted({str(s.get("service", "")) for s in snaps}),
            runs=sorted({str(s.get("run_id", ""))[:8] for s in snaps}),
        )
        stats.append(st)
        snapshots.extend(snaps)
    return snapshots, stats


def merge_runs(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet-wide merge of the final admitted snapshot of every run."""
    from ..utils.metric_journal import final_snapshots_by_run
    from ..utils.metrics import merge_sketch_states

    finals = final_snapshots_by_run(snapshots)
    counters: Dict[str, Dict[str, Any]] = {}
    gauges: Dict[str, List[Dict[str, Any]]] = {}
    sketches: Dict[str, Dict[str, Any]] = {}
    runs: List[Dict[str, Any]] = []
    for (service, run_id), snap in sorted(finals.items()):
        runs.append(
            {
                "service": service,
                "run_id": run_id,
                "pid": snap.get("pid"),
                "last_seq": snap.get("seq"),
                "last_ts": snap.get("ts"),
            }
        )
        for name, state in snap.get("metrics", {}).items():
            kind = state.get("type")
            labels = state.get("labels", [])
            if kind == "counter":
                acc = counters.setdefault(
                    name, {"labels": labels, "series": {}, "total": 0.0}
                )
                for key, value in state.get("series", []):
                    ls = _label_str(labels, key)
                    acc["series"][ls] = acc["series"].get(ls, 0.0) + value
                    acc["total"] += value
            elif kind == "gauge":
                for key, value in state.get("series", []):
                    gauges.setdefault(name, []).append(
                        {
                            "service": service,
                            "run_id": run_id[:8],
                            "labels": _label_str(labels, key),
                            "value": value,
                        }
                    )
            elif kind == "sketch":
                acc = sketches.setdefault(
                    name, {"labels": labels, "states": []}
                )
                acc["states"].extend(
                    st for _key, st in state.get("series", [])
                )
    merged_sketches: Dict[str, Dict[str, Any]] = {}
    for name, acc in sketches.items():
        merged_sketches[name] = {
            "labels": acc["labels"],
            "state": merge_sketch_states(acc["states"]),
        }
    return {
        "runs": runs,
        "counters": counters,
        "gauges": gauges,
        "sketches": merged_sketches,
    }


def fleet_quantiles(
    merged: Dict[str, Any], quantiles: List[float]
) -> Dict[str, Dict[str, Any]]:
    from ..utils.metrics import sketch_state_quantile

    out: Dict[str, Dict[str, Any]] = {}
    for name, entry in merged["sketches"].items():
        st = entry["state"]
        row: Dict[str, Any] = {
            "count": st["total"],
            "sum": round(st["sum"], 9),
            "alpha": st["alpha"],
            "min": st["min"],
            "max": st["max"],
        }
        for q in quantiles:
            v = sketch_state_quantile(st, q)
            row[f"p{q * 100:g}"] = None if v is None else round(v, 9)
        out[name] = row
    return out


def build_report(
    paths: List[str],
    *,
    quantiles: Optional[List[float]] = None,
    slo_config: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    snapshots, stats = load_journals(paths)
    merged = merge_runs(snapshots)
    report: Dict[str, Any] = {
        "journals": stats,
        "total_frames": sum(s["frames"] for s in stats),
        "total_corrupt": sum(s["corrupt"] for s in stats),
        "runs": merged["runs"],
        "counters": merged["counters"],
        "gauges": merged["gauges"],
        "quantiles": fleet_quantiles(merged, quantiles or [0.5, 0.9, 0.99]),
    }
    if slo_config:
        from ..utils.slo import replay_fleet

        engine = replay_fleet(snapshots, slo_config)
        report["slos"] = engine.state()["slos"]
    return report


def render_report(report: Dict[str, Any]) -> str:
    lines = [
        f"{len(report['journals'])} journal(s), "
        f"{report['total_frames']} frame(s) admitted, "
        f"{report['total_corrupt']} corrupt frame(s) REJECTED",
    ]
    for j in report["journals"]:
        frag = (
            f"- {j['path']}: {j['frames']} frame(s), "
            f"services={','.join(j['services']) or '—'}"
        )
        if j["corrupt"]:
            frag += f", {j['corrupt']} corrupt REJECTED"
        if j["torn_tail"]:
            frag += ", torn tail tolerated"
        lines.append(frag)
    lines.append("")
    lines.append(f"{len(report['runs'])} run(s) merged:")
    for r in report["runs"]:
        lines.append(
            f"- {r['service']} run {r['run_id'][:8]} "
            f"(pid {r['pid']}, {r['last_seq']} snapshot(s))"
        )
    if report["quantiles"]:
        lines += ["", "Fleet quantiles (sketches merged losslessly):", ""]
        header = sorted(
            {k for row in report["quantiles"].values() for k in row
             if k.startswith("p")}
        )
        lines.append("| metric | count | " + " | ".join(header) + " |")
        lines.append("| --- " * (2 + len(header)) + "|")
        for name, row in sorted(report["quantiles"].items()):
            cells = [
                f"{row[h] * 1e3:.2f} ms" if row.get(h) is not None else "—"
                for h in header
            ]
            lines.append(
                f"| {name} | {int(row['count'])} | " + " | ".join(cells) + " |"
            )
    if report["counters"]:
        lines += ["", "Fleet counters (summed per run identity):", ""]
        for name, acc in sorted(report["counters"].items()):
            lines.append(f"- {name}: {acc['total']:g}")
            for ls, v in sorted(acc["series"].items()):
                if ls != "{}":
                    lines.append(f"    {ls} {v:g}")
    for slo_state in report.get("slos", []):
        lines += [
            "",
            f"SLO {slo_state['name']}: "
            f"{'BREACHED' if slo_state['breached'] else 'ok'} "
            f"(burn fast {slo_state['burn_rate_fast']:.2f} / "
            f"slow {slo_state['burn_rate_slow']:.2f}, "
            f"threshold {slo_state['burn_threshold']:.2f})",
        ]
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dragonfly2_tpu_torch.bench.fleet_assemble",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("journals", nargs="+", help="per-process metric journals")
    p.add_argument("--json", action="store_true",
                   help="print the full report as JSON")
    p.add_argument("--quantiles", default="0.5,0.9,0.99",
                   help="comma-separated quantiles for the fleet table")
    p.add_argument("--slo-config", default=None, metavar="FILE",
                   help="JSON list of SLO declarations (config "
                        "telemetry.slos entries) to replay-evaluate")
    args = p.parse_args(argv)

    slo_config = None
    if args.slo_config:
        slo_config = json.loads(Path(args.slo_config).read_text())
    report = build_report(
        args.journals,
        quantiles=[float(x) for x in args.quantiles.split(",") if x],
        slo_config=slo_config,
    )
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
