"""The port's replay-determinism contracts (DF018/DF019), declared once
and checked twice.

Entry for entry with the reference's ``records/determinism_contracts.py``,
keyed by the port's relpaths: the replay roots, injection seams,
observability sinks and canonical-serialization writers the port has.
The reference's roots and writers in ``tools/`` map to the port's copies
under ``bench/``: the operators' readers ``fleet_assemble`` and
``trace_assemble``.  Those with no port module (``tools/bench_sched.py``,
``tools/bench_download.py``: measuring harnesses, which come with the
port's benchmark) have no entry.  One root is
the port's own: ``sim/qos.deterministic_summary``, the projection the
QoS hash-seed sweep holds byte for byte.

- ``tools/dflint/detrules.py`` reads it with ``ast.literal_eval`` when
  pointed at this file (its ``DETERMINISM_CONTRACTS_RELPATH`` names the
  reference's) and taints every function reachable from a root;
- ``utils/dfdet.py`` imports it at runtime to arm its recorder while a
  declared root is on the stack; ``tests/test_torch_witnesses.py`` holds
  the observations to the static taint report.

Keep this a PURE LITERAL: one dict, no imports used in the value, no
computed entries.
"""

from __future__ import annotations

DETERMINISM_CONTRACTS = {
    # -- replay roots -------------------------------------------------------
    # name -> {file, qual}: the functions whose output must be a pure
    # function of their inputs (journal bytes, snapshots, scripted
    # clocks).  Everything statically reachable from a root through the
    # project call graph is tainted by DF018.  The name is the stable
    # identity the runtime witness and the dual-run drill report by.
    "replay_roots": {
        "slo.ingest_snapshot": {
            "file": "dragonfly2_tpu_torch/utils/slo.py",
            "qual": "SLOEngine.ingest_snapshot",
        },
        "slo.evaluate": {
            "file": "dragonfly2_tpu_torch/utils/slo.py",
            "qual": "SLOEngine.evaluate",
        },
        "slo.replay_fleet": {
            "file": "dragonfly2_tpu_torch/utils/slo.py",
            "qual": "replay_fleet",
        },
        "autopilot.ingest": {
            "file": "dragonfly2_tpu_torch/qos/autopilot.py",
            "qual": "SLOAutopilot.ingest",
        },
        "autopilot.replay": {
            "file": "dragonfly2_tpu_torch/qos/autopilot.py",
            "qual": "SLOAutopilot.replay",
        },
        "accounting.note_at": {
            "file": "dragonfly2_tpu_torch/qos/accounting.py",
            "qual": "TenantAccounting.note_at",
        },
        "accounting.snapshot": {
            "file": "dragonfly2_tpu_torch/qos/accounting.py",
            "qual": "TenantAccounting.snapshot",
        },
        "rollout.breach": {
            "file": "dragonfly2_tpu_torch/rollout/controller.py",
            "qual": "RolloutController._breach",
        },
        "rollout.evaluate_shadow": {
            "file": "dragonfly2_tpu_torch/rollout/evaluation.py",
            "qual": "evaluate_shadow",
        },
        "rollout.regret_at_k": {
            "file": "dragonfly2_tpu_torch/rollout/evaluation.py",
            "qual": "regret_at_k",
        },
        "rollout.inversion_rate": {
            "file": "dragonfly2_tpu_torch/rollout/evaluation.py",
            "qual": "pairwise_inversion_rate",
        },
        "sharding.owner": {
            "file": "dragonfly2_tpu_torch/scheduler/sharding.py",
            "qual": "ShardRing.owner",
        },
        "sharding.pick": {
            "file": "dragonfly2_tpu_torch/scheduler/sharding.py",
            "qual": "ShardRing.pick",
        },
        "fleet_assemble.merge_runs": {
            "file": "dragonfly2_tpu_torch/bench/fleet_assemble.py",
            "qual": "merge_runs",
        },
        "fleet_assemble.build_report": {
            "file": "dragonfly2_tpu_torch/bench/fleet_assemble.py",
            "qual": "build_report",
        },
        "trace_assemble.critical_path": {
            "file": "dragonfly2_tpu_torch/bench/trace_assemble.py",
            "qual": "critical_path",
        },
        "trace_assemble.summarize_trace": {
            "file": "dragonfly2_tpu_torch/bench/trace_assemble.py",
            "qual": "summarize_trace",
        },
        "lifecycle.arbitrate": {
            "file": "dragonfly2_tpu_torch/lifecycle/arbiter.py",
            "qual": "arbitrate_candidates",
        },
        "lifecycle.epoch_plan": {
            "file": "dragonfly2_tpu_torch/lifecycle/arbiter.py",
            "qual": "plan_epoch",
        },
        # The QoS drill's seed-reproducible projection (sim/qos.py): the
        # counts a baseline arm replays byte for byte across hash seeds.
        "qos_drill.deterministic_summary": {
            "file": "dragonfly2_tpu_torch/sim/qos.py",
            "qual": "deterministic_summary",
        },
    },
    # -- injection seams ----------------------------------------------------
    # The ONLY doors nondeterminism may enter a replay path through: a
    # declared parameter on a declared function.  The live edge (tick(),
    # note(), the journal cadence thread) samples the ambient source
    # OUTSIDE the taint closure and passes the value in; replay passes
    # journal timestamps / scripted clocks through the same door.  Each
    # entry must name a real parameter of a real function — stale seams
    # fail DF018 by name.
    "injection_seams": [
        {
            "file": "dragonfly2_tpu_torch/utils/slo.py",
            "qual": "SLOEngine.evaluate",
            "params": ["now"],
            "kind": "clock",
        },
        {
            "file": "dragonfly2_tpu_torch/qos/accounting.py",
            "qual": "TenantAccounting.note_at",
            "params": ["now"],
            "kind": "clock",
        },
        {
            "file": "dragonfly2_tpu_torch/qos/accounting.py",
            "qual": "TenantAccounting.__init__",
            "params": ["now"],
            "kind": "clock",
        },
        {
            "file": "dragonfly2_tpu_torch/utils/metric_journal.py",
            "qual": "MetricJournal.__init__",
            "params": ["run_id"],
            "kind": "identity",
        },
        {
            "file": "dragonfly2_tpu_torch/rpc/ratelimit.py",
            "qual": "TokenBucket.take_at",
            "params": ["now"],
            "kind": "clock",
        },
        {
            "file": "dragonfly2_tpu_torch/sim/fleet.py",
            "qual": "FleetConfig",
            "params": ["seed"],
            "kind": "rng",
        },
        {
            "file": "dragonfly2_tpu_torch/sim/qos.py",
            "qual": "QoSDrillConfig",
            "params": ["seed"],
            "kind": "rng",
        },
        {
            "file": "dragonfly2_tpu_torch/sim/lifecycle.py",
            "qual": "LifecycleDrillConfig",
            "params": ["seed"],
            "kind": "rng",
        },
    ],
    # -- observability sinks -------------------------------------------------
    # Fire-and-forget diagnostics reachable from replay paths whose
    # values NEVER flow back into decision output: the flight recorder
    # (span timestamps are wall-clock by design), metric gauge/counter
    # writes, and the chaos seam.  DF018 taint does not descend into a
    # callee matching one of these prefixes ("relpath:*" = whole
    # module, "relpath:Qual" = one function/method), and the runtime
    # witness excuses ambient reads observed inside their spans.
    "sinks": [
        "dragonfly2_tpu_torch/utils/tracing.py:*",
        "dragonfly2_tpu_torch/utils/faultinject.py:*",
        "dragonfly2_tpu_torch/utils/metrics.py:Counter.inc",
        "dragonfly2_tpu_torch/utils/metrics.py:Gauge.set",
        "dragonfly2_tpu_torch/utils/metrics.py:Sketch.observe",
    ],
    # -- canonical serialization (DF019) -------------------------------------
    # Every journal/replay artifact writer: each ``json.dumps`` in the
    # writer must pin ``sort_keys=True``, and when a frame payload
    # builder is declared, the dict literal it returns must carry
    # exactly the declared key set (drift fails in BOTH directions).
    "serialization": {
        "metric_journal.frame": {
            "file": "dragonfly2_tpu_torch/utils/metric_journal.py",
            "qual": "encode_frame",
            "format": "DFMJ1",
            "builder": "MetricJournal._payload",
            "keys": ["metrics", "pid", "run_id", "seq", "service", "ts", "v"],
        },
        "trace_log.frame": {
            "file": "dragonfly2_tpu_torch/utils/tracing.py",
            "qual": "DurableSpanExporter._write",
            "format": "DFTL1",
            "builder": "build_export_request",
            "keys": ["resourceSpans"],
        },
        "columnar.header": {
            "file": "dragonfly2_tpu_torch/records/columnar.py",
            "qual": "_encode_header",
            "format": "DFC1",
            "builder": "_encode_header",
            "keys": ["columns", "created_at_ns", "dtype"],
        },
        "fleet_assemble.json": {
            "file": "dragonfly2_tpu_torch/bench/fleet_assemble.py",
            "qual": "main",
            "format": "json",
        },
        "trace_assemble.json": {
            "file": "dragonfly2_tpu_torch/bench/trace_assemble.py",
            "qual": "main",
            "format": "json",
        },
    },
}
