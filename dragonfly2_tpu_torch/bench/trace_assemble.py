"""Stitch per-process flight-recorder logs into end-to-end traces.

Every plane writes its own crash-safe trace log (``--trace-log`` /
config ``tracing.log_path`` — utils/tracing.py DurableSpanExporter).
One trace id follows a download across daemon → scheduler → manager via
the W3C ``traceparent`` header, so the logs of N processes hold the
N process-local shards of each trace.  This tool reassembles them and
answers the operator's question: *where did this download's 400 ms go?*

  python -m dragonfly2_tpu_torch.bench.trace_assemble LOG [LOG ...]
      [--trace-id HEX]         # pick a trace (default: most spans)
      [--json]                 # machine-readable full report
      [--validate]             # every replayed frame must validate
                               # against utils/otlp_trace_schema.json
                               # (needs jsonschema: exit 2 without it)
      [--gap-ms 50]            # leaf-coverage gap threshold
      [--markdown FILE --update]   # rewrite FILE's marked block

What it computes, per assembled trace:

- **critical path** — from the latest-finishing root, repeatedly descend
  into the latest-finishing child: the chain of spans that bounded the
  trace's wall clock (announce → schedule → piece fetches → commit);
- **per-phase latency breakdown** — spans bucketed by name prefix
  (announce / schedule / piece / source / commit / eval / manager /
  train / other), with count, total and max duration, and the share of
  the trace wall;
- **gaps** — intervals inside the trace extent covered by NO leaf span
  (nobody was doing attributable work: poll waits, lost wakeups,
  unexported spans of a killed process);
- **anomalies** — orphan spans (parent id present but the parent span
  missing: a crashed process never exported it — the expected SIGKILL
  signature), error-status spans, children starting before their parent
  (cross-process clock skew), plus per-log corrupt-frame counts.

Torn tails are tolerated exactly as the exporter's framing promises: a
SIGKILL mid-append costs at most the unfinished tail frame; digest-bad
frames are counted and NEVER admitted.

``--markdown FILE --update`` renders the summary between markers (the
``tools/bench_report.py`` discipline)::

    <!-- trace:assembly:begin --> ... <!-- trace:assembly:end -->

Port of ``tools/trace_assemble.py``, the operator's reader beside
``bench/fleet_assemble.py`` (its metric twin), with the logic verbatim
over the port's ``utils/tracing`` and ``utils/otlp_trace_schema.json``.
The DFTL1 frames are the reference's, so either package's reader reads
the other's logs and gives the same report, the same rendered block
(its text included, so either reader's ``--update`` finds the other's
block current) and the same ``--json`` bytes.  ``jsonschema`` is
imported only for ``--validate``.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ASSEMBLY_BEGIN = "<!-- trace:assembly:begin -->"
ASSEMBLY_END = "<!-- trace:assembly:end -->"

# Span-name prefix → phase of the download story.  Order matters: first
# match wins.
PHASE_RULES: Tuple[Tuple[str, str], ...] = (
    ("rpc/announce_host", "announce"),
    ("rpc/register_peer", "schedule"),
    ("rpc/report_piece_failed", "schedule"),
    ("rpc/report_piece_finished", "commit"),
    ("rpc/report_pieces_finished", "commit"),
    ("rpc/report_peer_finished", "commit"),
    ("rpc/", "rpc"),
    ("daemon/source.piece", "source"),
    # The data-plane spans, split so the per-download table reads
    # piece-fetch vs commit vs report-flush instead of one blob:
    # ``daemon/piece`` is the fetch wall (wire + hedge), the scheduler's
    # report_piece(s)_finished handlers are the commit acknowledgment,
    # and ``daemon/report.flush`` is the batched-report RPC window.
    ("daemon/report.flush", "report_flush"),
    ("daemon/piece", "piece"),
    ("daemon/pex-worker", "piece"),
    ("daemon/download", "download"),
    ("scheduler/eval", "eval"),
    ("manager/replicate", "replicate"),
    ("manager/", "manager"),
    ("jobs/", "jobs"),
    ("rollout/", "rollout"),
    ("trainer/", "train"),
)


def phase_of(name: str) -> str:
    for prefix, phase in PHASE_RULES:
        if name.startswith(prefix):
            return phase
    return "other"


def _span_ns(raw: Dict[str, Any], key: str) -> int:
    try:
        return int(raw.get(key, 0))
    except (TypeError, ValueError):
        return 0


def _attrs_of(raw: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kv in raw.get("attributes", []):
        v = kv.get("value", {})
        if "intValue" in v:
            try:
                out[kv["key"]] = int(v["intValue"])
            except (TypeError, ValueError):
                out[kv["key"]] = v["intValue"]
        elif "doubleValue" in v:
            out[kv["key"]] = v["doubleValue"]
        elif "boolValue" in v:
            out[kv["key"]] = v["boolValue"]
        else:
            out[kv["key"]] = v.get("stringValue", "")
    return out


def load_logs(
    paths: List[str], *, validate: bool = False
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Replay every log → (spans, per-log stats).  With ``validate``,
    each admitted frame must pass the vendored OTLP schema (raises on
    the first violation — the chaos drill's "every durable span batch
    validates" bar)."""
    from ..utils.tracing import log_spans, replay_trace_log

    validator = None
    if validate:
        import jsonschema

        from ..utils.tracing import otlp_trace_schema

        validator = jsonschema.Draft202012Validator(otlp_trace_schema())

    spans: List[Dict[str, Any]] = []
    log_stats: List[Dict[str, Any]] = []
    for path in paths:
        requests, stats = replay_trace_log(path)
        if validator is not None:
            for req in requests:
                validator.validate(req)
        stats = dict(stats, path=str(path))
        log_stats.append(stats)
        for raw in log_spans(requests):
            spans.append(
                {
                    "trace_id": raw.get("traceId", ""),
                    "span_id": raw.get("spanId", ""),
                    "parent_id": raw.get("parentSpanId"),
                    "name": raw.get("name", ""),
                    "service": raw.get("service", ""),
                    "start_ns": _span_ns(raw, "startTimeUnixNano"),
                    "end_ns": _span_ns(raw, "endTimeUnixNano"),
                    "status": (raw.get("status") or {}).get("code", 1),
                    "status_message": (raw.get("status") or {}).get("message", ""),
                    "attrs": _attrs_of(raw),
                }
            )
    return spans, log_stats


def assemble(spans: List[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    traces: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for s in spans:
        traces[s["trace_id"]].append(s)
    for tid in traces:
        traces[tid].sort(key=lambda s: (s["start_ns"], s["end_ns"]))
    return dict(traces)


def critical_path(trace_spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Latest-finishing root, then repeatedly the latest-finishing child:
    the span chain that bounded the trace's wall clock.  Orphans (parent
    missing — e.g. a SIGKILLed process never exported it) count as
    roots, so a torn trace still renders a path."""
    by_id = {s["span_id"]: s for s in trace_spans}
    children: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    roots: List[Dict[str, Any]] = []
    for s in trace_spans:
        pid = s["parent_id"]
        if pid and pid in by_id:
            children[pid].append(s)
        else:
            roots.append(s)
    if not roots:
        return []
    path = [max(roots, key=lambda s: s["end_ns"])]
    while True:
        kids = children.get(path[-1]["span_id"])
        if not kids:
            return path
        path.append(max(kids, key=lambda s: s["end_ns"]))


def leaf_gaps(
    trace_spans: List[Dict[str, Any]], *, threshold_ns: int
) -> List[Dict[str, float]]:
    """Intervals inside the trace extent covered by NO leaf span: time
    where no attributable work ran (poll waits, stalls, or spans a dead
    process never exported)."""
    has_children = {
        s["parent_id"] for s in trace_spans if s["parent_id"]
    }
    leaves = [s for s in trace_spans if s["span_id"] not in has_children]
    if not leaves:
        return []
    t0 = min(s["start_ns"] for s in trace_spans)
    t1 = max(s["end_ns"] for s in trace_spans)
    intervals = sorted((s["start_ns"], s["end_ns"]) for s in leaves)
    gaps: List[Dict[str, float]] = []
    cursor = t0
    for start, end in intervals:
        if start - cursor >= threshold_ns:
            gaps.append(
                {
                    "start_ms": (cursor - t0) / 1e6,
                    "end_ms": (start - t0) / 1e6,
                    "duration_ms": (start - cursor) / 1e6,
                }
            )
        cursor = max(cursor, end)
    if t1 - cursor >= threshold_ns:
        gaps.append(
            {
                "start_ms": (cursor - t0) / 1e6,
                "end_ms": (t1 - t0) / 1e6,
                "duration_ms": (t1 - cursor) / 1e6,
            }
        )
    return gaps


def anomalies_of(trace_spans: List[Dict[str, Any]]) -> List[str]:
    by_id = {s["span_id"]: s for s in trace_spans}
    out: List[str] = []
    for s in trace_spans:
        pid = s["parent_id"]
        if pid and pid not in by_id:
            out.append(
                f"orphan span {s['name']} ({s['service']}): parent {pid[:8]}… "
                "missing — likely unexported by a crashed process"
            )
        elif pid and s["start_ns"] + 5_000_000 < by_id[pid]["start_ns"]:
            out.append(
                f"span {s['name']} starts {(by_id[pid]['start_ns'] - s['start_ns']) / 1e6:.1f} ms "
                f"before its parent {by_id[pid]['name']} — cross-process clock skew"
            )
        if s["status"] == 2:
            out.append(
                f"error span {s['name']} ({s['service']}): {s['status_message']}"
            )
    return out


def summarize_trace(
    trace_id: str, trace_spans: List[Dict[str, Any]], *, gap_ms: float = 50.0
) -> Dict[str, Any]:
    t0 = min(s["start_ns"] for s in trace_spans)
    t1 = max(s["end_ns"] for s in trace_spans)
    wall_ms = (t1 - t0) / 1e6
    phases: Dict[str, Dict[str, float]] = {}
    for s in trace_spans:
        p = phases.setdefault(
            phase_of(s["name"]), {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
        )
        dur = (s["end_ns"] - s["start_ns"]) / 1e6
        p["count"] += 1
        p["total_ms"] = round(p["total_ms"] + dur, 3)
        p["max_ms"] = round(max(p["max_ms"], dur), 3)
    if wall_ms > 0:
        for p in phases.values():
            p["pct_of_wall"] = round(100.0 * p["total_ms"] / wall_ms, 1)
    path = [
        {
            "name": s["name"],
            "service": s["service"],
            "start_ms": round((s["start_ns"] - t0) / 1e6, 3),
            "duration_ms": round((s["end_ns"] - s["start_ns"]) / 1e6, 3),
            "attrs": s["attrs"],
        }
        for s in critical_path(trace_spans)
    ]
    return {
        "trace_id": trace_id,
        "spans": len(trace_spans),
        "services": sorted({s["service"] for s in trace_spans}),
        "wall_ms": round(wall_ms, 3),
        "phases": dict(sorted(phases.items())),
        "critical_path": path,
        "gaps": leaf_gaps(trace_spans, threshold_ns=int(gap_ms * 1e6)),
        "anomalies": anomalies_of(trace_spans),
    }


def build_report(
    paths: List[str],
    *,
    trace_id: Optional[str] = None,
    gap_ms: float = 50.0,
    validate: bool = False,
) -> Dict[str, Any]:
    spans, log_stats = load_logs(paths, validate=validate)
    traces = assemble(spans)
    report: Dict[str, Any] = {
        "logs": log_stats,
        "traces": len(traces),
        "total_spans": len(spans),
    }
    if not traces:
        return report
    if trace_id is None:
        trace_id = max(traces, key=lambda t: len(traces[t]))
    if trace_id not in traces:
        raise SystemExit(f"trace {trace_id!r} not found in the given logs")
    report["trace"] = summarize_trace(trace_id, traces[trace_id], gap_ms=gap_ms)
    return report


def render_report(report: Dict[str, Any]) -> str:
    """The marker-delimited markdown block (bench_report.py discipline)."""
    lines = [
        ASSEMBLY_BEGIN,
        "Generated by `python tools/trace_assemble.py` from per-process",
        "flight-recorder logs (utils/tracing.py DurableSpanExporter).",
        "",
    ]
    for log in report["logs"]:
        frag = f"- `{log['path']}`: {log['frames']} frame(s)"
        if log["corrupt"]:
            frag += f", {log['corrupt']} corrupt frame(s) REJECTED"
        if log["torn_tail"]:
            frag += ", torn tail tolerated"
        lines.append(frag)
    lines.append("")
    trace = report.get("trace")
    if trace is None:
        lines += ["No assembled traces.", ASSEMBLY_END]
        return "\n".join(lines)
    lines += [
        f"Trace `{trace['trace_id']}` — {trace['spans']} span(s) across "
        f"{', '.join(trace['services']) or 'unknown services'}; wall "
        f"{trace['wall_ms']:.1f} ms.",
        "",
        "| phase | spans | total | max | % of wall |",
        "| --- | --- | --- | --- | --- |",
    ]
    for phase, p in trace["phases"].items():
        lines.append(
            f"| {phase} | {p['count']} | {p['total_ms']:.1f} ms | "
            f"{p['max_ms']:.1f} ms | {p.get('pct_of_wall', 0):.1f}% |"
        )
    lines += ["", "Critical path:", ""]
    for i, hop in enumerate(trace["critical_path"]):
        pad = "  " * i
        lines.append(
            f"- {pad}`{hop['name']}` ({hop['service']}) "
            f"@{hop['start_ms']:.1f} ms, {hop['duration_ms']:.1f} ms"
        )
    if trace["gaps"]:
        lines += ["", "Gaps (no leaf span running):", ""]
        for g in trace["gaps"]:
            lines.append(
                f"- {g['start_ms']:.1f}–{g['end_ms']:.1f} ms "
                f"({g['duration_ms']:.1f} ms idle)"
            )
    if trace["anomalies"]:
        lines += ["", "Anomalies:", ""]
        for a in trace["anomalies"]:
            lines.append(f"- {a}")
    lines.append(ASSEMBLY_END)
    return "\n".join(lines)


def update_file(path: Path, rendered: str) -> bool:
    text = path.read_text(encoding="utf-8")
    begin = text.find(ASSEMBLY_BEGIN)
    end = text.find(ASSEMBLY_END)
    if begin < 0 or end < 0:
        raise SystemExit(
            f"{path}: assembly markers not found "
            f"({ASSEMBLY_BEGIN} ... {ASSEMBLY_END})"
        )
    new = text[:begin] + rendered + text[end + len(ASSEMBLY_END):]
    if new != text:
        path.write_text(new, encoding="utf-8")
        return True
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dragonfly2_tpu_torch.bench.trace_assemble",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("logs", nargs="+", help="per-process trace log files")
    p.add_argument("--trace-id", default=None,
                   help="assemble this trace (default: the largest)")
    p.add_argument("--json", action="store_true",
                   help="print the full report as JSON")
    p.add_argument("--validate", action="store_true",
                   help="validate every admitted frame against the "
                        "vendored OTLP schema")
    p.add_argument("--gap-ms", type=float, default=50.0,
                   help="minimum uncovered interval reported as a gap")
    p.add_argument("--markdown", default=None, metavar="FILE",
                   help="markdown file carrying the marked block")
    p.add_argument("--update", action="store_true",
                   help="rewrite --markdown's marked block in place")
    args = p.parse_args(argv)

    try:
        report = build_report(
            args.logs, trace_id=args.trace_id, gap_ms=args.gap_ms,
            validate=args.validate,
        )
    except ImportError as exc:
        if exc.name != "jsonschema":
            raise
        print("trace_assemble: --validate needs the `jsonschema` package, which "
              "is not installed", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0
    rendered = render_report(report)
    if args.markdown and args.update:
        changed = update_file(Path(args.markdown), rendered)
        print(
            f"{args.markdown}: trace assembly "
            + ("updated" if changed else "already current")
        )
        return 0
    print(rendered)
    return 0


if __name__ == "__main__":
    sys.exit(main())
