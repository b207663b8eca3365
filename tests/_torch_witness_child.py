"""Child interpreter for tests/test_torch_witnesses.py: installs the
port's five witnesses, drives port workloads at small sizes, and writes
what the witnesses saw as JSON to ``argv[1]``.

``tests/conftest.py`` installs the reference's witnesses only (and the
pytest process has imported the port long before any test runs), so the
port's witnesses need an interpreter of their own: ``utils/dflock.py`` is
loaded by file path before any ``dragonfly2_tpu_torch`` import, as the
reference's conftest loads its own, and the other four follow.

Workloads (all on the CPU, where the kernel wrappers run their plain
versions): the serving slice (an ``ml`` scheduler from
``cli.scheduler.build``: announces, warm downloads, concurrent
registrations through the batcher and K1's scorer, then the same again
as the steady state), the QoS overload drill with the ``ml`` evaluator,
a shard-ring change (the guard's handoff sweep), the lifecycle drill
(epochs, promotion and rollback), the manager's state writes (registry,
rollout controller and job queue, in memory and on SQLite), and the
replay roots (the SLO replay, the
fleet report over metric journals, the shard ring, the drill's
deterministic summary).

Then, each against isolated records so none touches the clean ones, the
planted faults: the registry's ACTIVE flip split into sequential
``put``s, a ``time.time()`` read inside a replay root, and a scorer that
pads every flush to a new size.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import random
import sys
import tempfile
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dragonfly2_tpu_torch")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# -- the lock witness, before any port import --------------------------------
_spec = importlib.util.spec_from_file_location(
    "dragonfly2_tpu_torch.utils.dflock", os.path.join(PKG, "utils", "dflock.py"))
dflock = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(dflock)
sys.modules["dragonfly2_tpu_torch.utils.dflock"] = dflock
dflock.install(PKG)

import numpy as np  # noqa: E402

from dragonfly2_tpu_torch.utils import dfcrash, dfdet, dfspan, dftrace  # noqa: E402

dftrace.install()
dfcrash.install(PKG)
dfspan.install(PKG)
dfdet.install(PKG)

# How often each replay root armed the determinism witness.
_ARMED = {}
_push_root = dfdet.witness().push_root


def _counting_push(name: str) -> None:
    _ARMED[name] = _ARMED.get(name, 0) + 1
    _push_root(name)


dfdet.witness().push_root = _counting_push

# Which port files the workloads REACH (ran a function of), as opposed to
# merely imported: one PY_START event per code object, then disabled.
_REACHED = set()
_MON = sys.monitoring
_TOOL = _MON.PROFILER_ID


def _on_start(code, _offset):
    # Functions only: module and class bodies run at import.
    if code.co_flags & inspect.CO_OPTIMIZED and code.co_filename.startswith(PKG + os.sep):
        _REACHED.add(os.path.relpath(code.co_filename, REPO).replace(os.sep, "/"))
    return _MON.DISABLE


_MON.use_tool_id(_TOOL, "port-witness-reach")
_MON.register_callback(_TOOL, _MON.events.PY_START, _on_start)
_MON.set_events(_TOOL, _MON.events.PY_START)

REGISTRY_RELPATH = "dragonfly2_tpu_torch/manager/registry.py"
PUT_MANY_NEEDLE = (
    "            self._table.put_many({m.id: _model_to_doc(m) for m in models})"
)
PUT_SPLIT_REPL = (
    "            [self._table.put(m.id, _model_to_doc(m)) for m in models]"
)
SUMMARY_NEEDLE = "    return {k: arm_report[k] for k in COUNT_KEYS if k in arm_report}"
SUMMARY_REPL = "    time.time()\n" + SUMMARY_NEEDLE

PIECES = 4
PIECE_SIZE = 16 * 1024


def _mutant(relpath: str, needle: str, repl: str, name: str) -> dict:
    """A module compiled from the port's source with one line replaced,
    under the real file name (its frames map to the real relpath)."""
    import types

    path = os.path.join(REPO, relpath)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert needle in src, (relpath, needle)
    pkg = relpath[: -len(os.path.basename(relpath)) - 1].replace("/", ".")
    mod = types.ModuleType(f"{pkg}.{name}")
    mod.__package__ = pkg
    mod.__file__ = path
    sys.modules[mod.__name__] = mod
    exec(compile(src.replace(needle, repl), path, "exec"), mod.__dict__)  # noqa: S102
    return mod.__dict__


def serving(workdir: str) -> dict:
    """The K1 serving slice on the CPU: every flush's ``jit_compiles``,
    and the shape witness's total before and after a steady-state round."""
    from dragonfly2_tpu_torch.bench.wire_loop import seeded_k1_blob
    from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
    from dragonfly2_tpu_torch.scheduler import ShardGuard
    from dragonfly2_tpu_torch.scheduler.sharding import ShardRing
    from dragonfly2_tpu_torch.sim.swarm import host_from_latent
    from dragonfly2_tpu_torch.utils import tracing

    cfg = SchedulerConfig()
    cfg.storage.dir = os.path.join(workdir, "records")
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.eval_feature_cache_hosts = 1024
    cfg.scheduling.retry_interval_s = 0.0
    service = build(cfg, device="cpu", scorer_blob=seeded_k1_blob(0),
                    rng=random.Random(0), seed_trigger=False)
    hosts = [host_from_latent(h) for h in SyntheticCluster(num_hosts=256, seed=0).hosts]
    for h in hosts:
        service.announce_host(h)
    urls = [f"https://origin.example.com/blob/{t}" for t in range(4)]
    for t, url in enumerate(urls):
        for k in range(8):
            res = service.register_peer(host=hosts[t * 8 + k], url=url, peer_id=f"w-{t}-{k}")
            peer = res.peer
            service.set_task_info(peer, PIECES * PIECE_SIZE, PIECES, PIECE_SIZE)
            sched = res.schedule
            parent = sched.parents[0].id if sched is not None and sched.parents else ""
            for n in range(PIECES):
                service.report_piece_finished(peer, n, parent_id=parent, length=PIECE_SIZE,
                                              cost_ns=1_000_000 + 1000 * k)
            service.report_peer_finished(peer)

    ring = tracing.InMemoryExporter(max_spans=1 << 14)
    saved = tracing.default_tracer.exporter
    tracing.default_tracer.exporter = ring

    def round_of(first: int) -> None:
        def worker(t: int) -> None:
            for i in range(4):
                q = first + t * 4 + i
                service.register_peer(host=hosts[64 + q], url=urls[q % 4], peer_id=f"r-{q}")

        threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)

    try:
        round_of(0)
        w = dftrace.witness()
        first_total = w.total_compiles()
        round_of(16)
        steady_total = w.total_compiles()
    finally:
        tracing.default_tracer.exporter = saved
    # A membership change: the guard's handoff sweep over the live tasks.
    guard = ShardGuard("wit-shard")
    guard.resource = service.resource
    moved = guard.update_ring(ShardRing({"wit-shard": "", "other": ""}, version=1))
    flushes = [s.attributes.get("jit_compiles") for s in ring.spans
               if s.name == "scheduler/eval.flush"]
    scorer = service.scheduling.evaluator._scorer
    return {"flush_jit_compiles": flushes, "first_total": first_total,
            "steady_total": steady_total, "scorer_shapes": sorted(dftrace.shapes_of(scorer)),
            "scorer_calls": service.scheduling.evaluator.batcher.scorer_calls,
            "handed_off": len(moved)}


def lifecycle() -> bool:
    """The lifecycle drill: epochs, promotion and rollback through the
    rollout controller and the lifecycle store."""
    from dragonfly2_tpu_torch.sim import lifecycle as sim

    return sim.run_lifecycle_drill(sim.LifecycleDrillConfig(
        epoch_records=128, batch_size=32, announces=24, parents=4,
        min_shadow_samples=40, min_canary_samples=40), device="cpu")["ok"]


def qos_drill(workdir: str) -> dict:
    from dragonfly2_tpu_torch.bench.bench_qos import MLEvaluators
    from dragonfly2_tpu_torch.bench.wire_loop import seeded_k1_blob
    from dragonfly2_tpu_torch.sim import qos

    evaluators = MLEvaluators(seeded_k1_blob(0), "cpu")
    out = qos.run_isolation_drill(
        qos.QoSDrillConfig(a_announces=120, a_downloads=2, pieces_per_task=2,
                           piece_size=16 * 1024, b_threads=1),
        evaluator=evaluators, extra_parents=2)
    # A pass-through stream off the drill's seed (the daemon/stream span).
    state = qos._build(qos.QoSDrillConfig(a_downloads=1, pieces_per_task=2,
                                          piece_size=16 * 1024),
                       shaped=False, workdir=workdir)
    body = state.client_a.open_stream(state.a_urls[0], piece_size=16 * 1024).read_all()
    return {"a_downloads_ok": [out[k]["a_downloads_ok"] for k in ("baseline", "unshaped", "shaped")],
            "stream_bytes": len(body),
            "summary": qos.deterministic_summary(out["baseline"]),
            "scorer_calls": evaluators.scorer_calls(),
            "scorer_shapes": [sorted(dftrace.shapes_of(ev._scorer)) for ev in evaluators.built]}


def _drive_registry(registry_cls, backend):
    registry = registry_cls(backend=backend)
    m1 = registry.create_model(name="m", type="mlp", scheduler_id="s", artifact=b"\x01" * 8)
    m2 = registry.create_model(name="m", type="mlp", scheduler_id="s", artifact=b"\x02" * 8)
    registry.activate(m1.id)
    registry.activate(m2.id)          # two-row flip: ONE put_many, 2 rows
    return registry


def manager_writes(workdir: str) -> None:
    from dragonfly2_tpu_torch.jobs.queue import JobQueue
    from dragonfly2_tpu_torch.manager.registry import ModelRegistry
    from dragonfly2_tpu_torch.manager.state import MemoryBackend, SQLiteBackend
    from dragonfly2_tpu_torch.rollout.controller import RolloutController

    for backend in (MemoryBackend(), SQLiteBackend(os.path.join(workdir, "state.db"))):
        registry = _drive_registry(ModelRegistry, backend)
        controller = RolloutController(registry, backend=backend)
        m3 = registry.create_model(name="m", type="mlp", scheduler_id="s", artifact=b"\x03" * 8)
        controller.begin(m3.id)
        controller.delete_model(m3.id)
        q = JobQueue(backend=backend)
        q.enqueue("preheat", {"url": "http://x/1"}, group_id="g")
        q.enqueue("preheat", {"url": "http://x/2"}, group_id="g")
        backend.close()


def replay_roots(workdir: str) -> dict:
    from dragonfly2_tpu_torch.bench.fleet_assemble import build_report
    from dragonfly2_tpu_torch.scheduler.sharding import ShardRing
    from dragonfly2_tpu_torch.sim.telemetry import DRILL_SLO
    from dragonfly2_tpu_torch.utils.metric_journal import (
        MetricJournal,
        replay_metric_journal,
    )
    from dragonfly2_tpu_torch.utils.metrics import Registry
    from dragonfly2_tpu_torch.utils.slo import replay_fleet

    journals = []
    for i in range(2):
        reg = Registry()
        sk = reg.sketch("drill_fetch_seconds", "")
        path = os.path.join(workdir, f"p{i}.dfmj")
        j = MetricJournal(path, registry=reg, service=f"d{i}", interval_s=3600.0,
                          run_id=f"run-{i}")
        for k in range(50):
            sk.observe(0.01 if k % 10 else 0.5)
            if k % 10 == 9:
                j.write_snapshot()
        j.close()
        journals.append(path)
    report = build_report(journals, slo_config=[DRILL_SLO])
    snaps, _ = replay_metric_journal(journals[0])
    state = replay_fleet(snaps, [DRILL_SLO]).state()["slos"][0]
    ring = ShardRing({"a": "", "b": "", "c": ""})
    owners = [ring.owner(f"task-{i}") for i in range(16)] + [ring.pick("task-0")]
    return {"fleet_count": report["quantiles"]["drill_fetch_seconds"]["count"],
            "breached": state["breached"], "owners": owners}


def faults() -> dict:
    from dragonfly2_tpu_torch.manager.state import MemoryBackend
    from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
    from dragonfly2_tpu_torch.scheduler import HostFeatureCache
    from dragonfly2_tpu_torch.trainer.export import load_scorer
    from dragonfly2_tpu_torch.bench.wire_loop import seeded_k1_blob

    out = {}
    # 1. the ACTIVE flip split into sequential puts
    ns = _mutant(REGISTRY_RELPATH, PUT_MANY_NEEDLE, PUT_SPLIT_REPL, "_registry_split_mutant")
    with dfcrash.isolated() as w:
        _drive_registry(ns["ModelRegistry"], MemoryBackend())
        out["crash_split"] = _crash_snapshot(w)
    # 2. time.time() inside the drill's summary root
    ns = _mutant("dragonfly2_tpu_torch/sim/qos.py", SUMMARY_NEEDLE, SUMMARY_REPL,
                 "_qos_clock_mutant")
    with dfdet.isolated() as w:
        with dfdet.armed("qos_drill.deterministic_summary"):
            ns["deterministic_summary"]({"shaped": False, "a_announces": 1})
        out["det_clock"] = w.snapshot()

    # 3. a scorer that pads every flush to a new size
    class ChurningScorer(FusedMLPScorer):
        def score(self, features, *, src_buckets=None, dst_buckets=None):
            got = super().score(features, src_buckets=src_buckets, dst_buckets=dst_buckets)
            self.cand_block += 8
            return got

    # The clean counts were read before the faults ran.
    w = dftrace.witness()
    w.reset()
    cache = HostFeatureCache(max_hosts=64)
    scorer = ChurningScorer.from_scorer(cache, load_scorer(seeded_k1_blob(0)), device="cpu")
    edge = np.zeros((5, 8), np.float32)
    slots = np.zeros(5, np.int64)
    for _ in range(6):
        scorer.score(edge, src_buckets=slots, dst_buckets=slots)
    out["churn_over_budget"] = w.over_budget()
    out["churn_shapes"] = sorted(dftrace.shapes_of(scorer))
    return out


def _crash_snapshot(w) -> dict:
    return {f"{rel}:{line}": recs for (rel, line), recs in w.snapshot().items()}


def imported_relpaths() -> list:
    out = []
    for mod in list(sys.modules.values()):
        f = getattr(mod, "__file__", None)
        if f and os.path.abspath(f).startswith(PKG + os.sep):
            out.append(os.path.relpath(os.path.abspath(f), REPO).replace(os.sep, "/"))
    return sorted(set(out))


def main() -> int:
    out_path = sys.argv[1]
    with tempfile.TemporaryDirectory() as workdir:
        doc = {"serving": serving(workdir), "qos": qos_drill(workdir), "lifecycle": lifecycle()}
        manager_writes(workdir)
        doc["replay"] = replay_roots(workdir)
    doc["lock_edges"] = [[list(a), list(b)] for (a, b) in dflock.witness().snapshot_edges()]
    doc["spans"] = [[rel, name, kind, n] for (rel, name, kind), n in
                    sorted(dfspan.witness().snapshot().items())]
    doc["crash"] = _crash_snapshot(dfcrash.witness())
    doc["det"] = dfdet.witness().snapshot()
    doc["det_roots"] = sorted(dfdet.witness().wrapped_roots)
    doc["det_armed"] = dict(_ARMED)
    doc["shapes"] = dftrace.witness().snapshot()
    doc["shapes_over_budget"] = dftrace.witness().over_budget()
    _MON.set_events(_TOOL, 0)
    doc["imported"] = imported_relpaths()
    doc["reached"] = sorted(_REACHED)
    doc["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dragonfly2_tpu", "tools"))
    doc["faults"] = faults()
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
