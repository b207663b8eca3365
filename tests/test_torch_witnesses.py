"""The port's five runtime witnesses, held to the static analysis.

``tests/_torch_witness_child.py`` installs ``dragonfly2_tpu_torch``'s own
lock, shape, crash, span and determinism witnesses in a child interpreter
(``tests/conftest.py`` installs only the reference's, and cannot change),
drives port workloads at small sizes on the CPU, and writes what the
witnesses saw.  This file builds ``tools/dflint``'s whole-program view of
the port (``Program.from_paths([dragonfly2_tpu_torch])``) while the child
runs, and checks, in the mould of the reference's
``tests/test_zz_{lock,compile,crash,span,det}witness.py``:

- every lock-order edge observed is in the static lock graph;
- every span observed matches a statically extracted site and the port's
  inventory (``utils/dfspan.REQUIRED_SPANS``), and every inventoried site
  of a module the workloads reached (ran a function of) was observed;
- every KVTable write site is in the static persistence inventory built
  from ``records/state_contracts.py``, and the multi-row flip is seen only
  as ONE ``put_many``;
- every ambient read while a replay root was armed is at a site the
  static taint report (``records/determinism_contracts.py``) knows;
- every scorer stays within its padded-shape budget, the steady state adds
  no shape, and ``scheduler/eval.flush`` carries the witness's count.

Each check is shown to fail on a planted fault: a lock edge taken out of
the graph, an inventoried span deleted, the ``put_many`` split in two, a
``time.time()`` inside a replay root, and a scorer that pads each flush
to a new size.  The dflint rules keyed by the reference's relpaths are
pointed at the port's contract files for the analysis only (the module
constants are restored at once); nothing under ``tools/`` changes.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dragonfly2_tpu_torch"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.dflint.checkers.df016_spans import (  # noqa: E402
    REQUIRED_SPANS as REF_REQUIRED_SPANS,
    site_matches,
    span_sites,
)
from tools.dflint.core import load_module  # noqa: E402
from tools.dflint.program import Program, witness_gaps  # noqa: E402

from dragonfly2_tpu_torch.utils.dfspan import REQUIRED_SPANS  # noqa: E402
from dragonfly2_tpu_torch.utils.dftrace import SHAPE_SITES  # noqa: E402

REGISTRY_RELPATH = "dragonfly2_tpu_torch/manager/registry.py"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the child's report, the port's Program): the child runs while the
    static view is built."""
    out = tmp_path_factory.mktemp("witness") / "witness.json"
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_witness_child.py"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(REPO),
    )
    try:
        program = Program.from_paths([PKG], REPO)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (stdout.decode()[-2000:], stderr.decode()[-4000:])
    return json.loads(out.read_text()), program


@pytest.fixture(scope="module")
def doc(runs):
    return runs[0]


@pytest.fixture(scope="module")
def program(runs):
    return runs[1]


def _with_relpath(module, name, relpath, build):
    saved = getattr(module, name)
    setattr(module, name, relpath)
    try:
        return build()
    finally:
        setattr(module, name, saved)


@pytest.fixture(scope="module")
def state_analysis(program):
    import tools.dflint.staterules as sr

    return _with_relpath(sr, "STATE_CONTRACTS_RELPATH",
                         "dragonfly2_tpu_torch/records/state_contracts.py",
                         lambda: sr.StateAnalysis(program, REPO))


@pytest.fixture(scope="module")
def det_analysis(program):
    import tools.dflint.detrules as dr

    return _with_relpath(dr, "DETERMINISM_CONTRACTS_RELPATH",
                         "dragonfly2_tpu_torch/records/determinism_contracts.py",
                         lambda: dr.DetAnalysis(program, REPO))


def _edges(doc):
    return {(tuple(a), tuple(b)): "child" for a, b in doc["lock_edges"]}


def _names_by_module(doc):
    out = {}
    for rel, name, _kind, _n in doc["spans"]:
        out.setdefault(rel, set()).add(name)
    return out


def _crash(snapshot):
    out = {}
    for key, recs in snapshot.items():
        rel, line = key.rsplit(":", 1)
        out[(rel, int(line))] = recs
    return out


def missing_coverage(names_by_module, reached):
    """Inventoried (module, site) pairs not observed, for modules reached."""
    out = []
    for rel, sites in REQUIRED_SPANS.items():
        if rel not in reached:
            continue
        names = names_by_module.get(rel, set())
        out += [(rel, s) for s in sites if not any(site_matches(s, n) for n in names)]
    return out


class TestWorkloads:
    def test_child_drove_every_workload_without_jax(self, doc):
        assert doc["modules"] == [], "the child imported jax, dragonfly2_tpu or tools"
        assert doc["qos"]["a_downloads_ok"] == [2, 2, 2]
        assert doc["qos"]["stream_bytes"] == 2 * 16 * 1024
        assert doc["qos"]["scorer_calls"] > 0 and doc["serving"]["scorer_calls"] > 0
        assert doc["lifecycle"] is True
        assert doc["serving"]["handed_off"] > 0
        assert doc["replay"]["fleet_count"] == 100

    def test_each_witness_recorded(self, doc):
        from dragonfly2_tpu_torch.records.determinism_contracts import (
            DETERMINISM_CONTRACTS,
        )

        assert doc["lock_edges"] and doc["spans"] and doc["crash"] and doc["shapes"]
        assert doc["det_roots"] == sorted(DETERMINISM_CONTRACTS["replay_roots"])
        for root in ("qos_drill.deterministic_summary", "accounting.note_at",
                     "accounting.snapshot", "slo.replay_fleet",
                     "fleet_assemble.build_report", "sharding.owner",
                     "rollout.breach"):
            assert doc["det_armed"].get(root, 0) > 0, (root, doc["det_armed"])


class TestLockWitness:
    def test_every_edge_is_in_the_static_graph(self, doc, program):
        gaps = witness_gaps(program, _edges(doc))
        assert not gaps, "\n".join(gaps)

    def test_registry_to_table_edge_observed(self, doc, program):
        index = program.creation_site_index()
        mapped = {(index.get(a), index.get(b)) for a, b in _edges(doc)}
        assert any(s and d and s.endswith("ModelRegistry._mu") and d.endswith("_MemTable._mu")
                   for s, d in mapped), sorted(mapped, key=str)

    def test_edge_taken_out_of_the_graph_is_caught(self, doc, program):
        victim = next((s, d) for s, d in program.edge_keys()
                      if s.endswith("ModelRegistry._mu") and d.endswith("_MemTable._mu"))
        gaps = witness_gaps(program, _edges(doc),
                            static_edges=program.edge_keys() - {victim})
        assert any("_MemTable._mu" in g for g in gaps), gaps


class TestSpanWitness:
    def test_port_inventory_is_the_references(self):
        for ref_rel, sites in REF_REQUIRED_SPANS.items():
            rel = ref_rel.replace("dragonfly2_tpu/", "dragonfly2_tpu_torch/", 1)
            if (REPO / rel).exists():
                assert REQUIRED_SPANS.get(rel) == sites, rel
            else:
                assert rel not in REQUIRED_SPANS
        assert all((REPO / rel).exists() for rel in REQUIRED_SPANS)

    def test_static_extractor_finds_every_inventoried_site(self):
        for rel, sites in REQUIRED_SPANS.items():
            present = span_sites(load_module(REPO / rel, REPO))
            assert set(sites) <= present, (rel, sorted(present))

    def test_observed_spans_match_static_sites(self, doc):
        for rel, names in _names_by_module(doc).items():
            static = span_sites(load_module(REPO / rel, REPO))
            for name in names:
                assert any(site_matches(s, name) for s in static), (rel, name)

    def test_inventoried_sites_of_reached_modules_observed(self, doc):
        reached = set(doc["reached"])
        for rel in ("dragonfly2_tpu_torch/daemon/conductor.py",
                    "dragonfly2_tpu_torch/scheduler/microbatch.py",
                    "dragonfly2_tpu_torch/scheduler/sharding.py",
                    "dragonfly2_tpu_torch/rollout/controller.py",
                    "dragonfly2_tpu_torch/lifecycle/daemon.py"):
            assert rel in reached, rel
        assert missing_coverage(_names_by_module(doc), reached) == []

    def test_deleted_span_site_is_caught(self, doc):
        by_mod = _names_by_module(doc)
        doctored = {rel: ({n for n in names if n != "daemon/stream"}
                          if rel == "dragonfly2_tpu_torch/daemon/conductor.py" else names)
                    for rel, names in by_mod.items()}
        missing = missing_coverage(doctored, set(doc["reached"]))
        assert missing == [("dragonfly2_tpu_torch/daemon/conductor.py", "daemon/stream")]


class TestCrashWitness:
    def test_static_persistence_inventory_is_clean(self, state_analysis):
        assert [f.render() for f in state_analysis.findings()] == []
        assert state_analysis.multi_row_sites() == {
            f"{REGISTRY_RELPATH}:ModelRegistry._persist": "models"}

    def test_every_write_site_is_in_the_inventory(self, doc, state_analysis):
        from tools.dflint.staterules import crash_witness_gaps

        gaps = crash_witness_gaps(state_analysis, _crash(doc["crash"]))
        assert not gaps, "\n".join(gaps)

    def test_multi_row_flip_observed_as_one_put_many(self, doc, state_analysis):
        fi = state_analysis.program.funcs[f"{REGISTRY_RELPATH}:ModelRegistry._persist"]
        span = range(fi.node.lineno, fi.node.end_lineno + 1)
        seen = [r for (rel, line), recs in _crash(doc["crash"]).items()
                if rel == REGISTRY_RELPATH and line in span for r in recs]
        assert seen and all(r["method"] == "put_many" for r in seen), seen
        assert any(r["max_rows"] >= 2 for r in seen), seen

    def test_put_many_split_in_two_is_caught(self, doc, state_analysis):
        from tools.dflint.staterules import crash_witness_gaps

        gaps = crash_witness_gaps(state_analysis, _crash(doc["faults"]["crash_split"]))
        assert any("multi-row site" in g and "ModelRegistry._persist" in g and "put()" in g
                   for g in gaps), gaps


class TestDetWitness:
    def test_static_taint_report_is_clean(self, det_analysis):
        assert [f.render() for f in det_analysis.findings()] == []
        assert "qos_drill.deterministic_summary" in det_analysis.replay_root_index()

    def test_every_ambient_read_under_a_root_is_known(self, doc, det_analysis):
        from tools.dflint.detrules import det_witness_gaps

        gaps = det_witness_gaps(det_analysis, doc["det"])
        assert not gaps, "\n".join(gaps)

    def test_clock_read_inside_a_root_is_caught(self, doc, det_analysis):
        from tools.dflint.detrules import det_witness_gaps

        planted = doc["faults"]["det_clock"]
        assert [r["source"] for r in planted] == ["time.time"]
        gaps = det_witness_gaps(det_analysis, planted)
        assert len(gaps) == 1 and "time.time" in gaps[0] and "sim/qos.py" in gaps[0], gaps


class TestShapeWitness:
    def test_budgets_are_the_references(self):
        budget = tomllib.loads(
            (REPO / "tools" / "dflint" / "compile_budget.toml").read_text())["budget"]
        for spec in SHAPE_SITES.values():
            assert budget[spec["reference"]] == spec["budget"], spec

    def test_padded_sizes_within_budget(self, doc):
        assert doc["shapes_over_budget"] == {}
        for key, stats in doc["shapes"].items():
            assert 0 < stats["max_compiles"] <= SHAPE_SITES[key]["budget"], (key, stats)
        for shapes in [doc["serving"]["scorer_shapes"], *doc["qos"]["scorer_shapes"]]:
            assert 0 < len(shapes) <= 4, shapes

    def test_steady_state_adds_no_shape(self, doc):
        serving = doc["serving"]
        assert serving["first_total"] > 0
        assert serving["steady_total"] == serving["first_total"]
        flushes = serving["flush_jit_compiles"]
        assert flushes and all(n == serving["first_total"] for n in flushes), flushes

    def test_scorer_padding_to_a_new_size_each_call_is_caught(self, doc):
        over = doc["faults"]["churn_over_budget"]
        key = "dragonfly2_tpu_torch/ops/fused_score.py:FusedMLPScorer.__init__"
        assert over[key]["max_compiles"] == 6 > SHAPE_SITES[key]["budget"], over
        assert doc["faults"]["churn_shapes"] == [128, 136, 144, 152, 160, 168]
