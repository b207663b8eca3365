"""dflint over ``dragonfly2_tpu_torch/``, and the port's dtype contracts.

``tests/test_lint.py`` lints the reference only.  Here ``tools/dflint``
runs over the port: one parametrised case per source file, so a finding
names the file.  Only the rules that key on no reference relpath and no
``jax`` construct run:

- per file (``RULES``): DF001 exceptions, DF002 threads, DF005 resources,
  DF006 deadlines, DF021 native exceptions;
- whole program: DF008 blocking under a lock and DF009 lock-order cycles
  (``tools/dflint/program.py``), and DF012 columnar dtype contracts
  (``tools/dflint/tracerules.py``) read from the port's own
  ``records/contracts.py``.

Left out: DF003 (jax purity) and DF010/DF011 (jit retrace, host syncs
under jit) check ``jax`` constructs; DF004, DF007, DF016, DF017 and DF020
check tables keyed by the reference's relpaths (DF016's span inventory is
held for the port by ``tests/test_torch_witnesses.py``, as are DF014 and
DF018 with the port's state and determinism contracts); DF013 and DF015
check FSM and RPC sections the port's contracts do not carry.  The
reference's ``tools/dflint/baseline.toml`` accepts no finding, and
neither does this file.

Beside the lint, the contracts are held at run time: the DFC1 columns
equal ``records.features``, the slot matrix is ``[S, 12]`` float32, and
K1, K2 and K3's plain versions return the dtypes ``outputs`` declares.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dragonfly2_tpu_torch"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.dflint.checkers import RULES as CHECKERS_BY_RULE  # noqa: E402
from tools.dflint.core import Module, collect_files, load_module, run_checkers  # noqa: E402
from tools.dflint.program import Program  # noqa: E402

RULES = ("DF001", "DF002", "DF005", "DF006", "DF021")
PROGRAM_RULES = ("DF008", "DF009", "DF012")
CONTRACTS_RELPATH = "dragonfly2_tpu_torch/records/contracts.py"
SOURCE_FILES = collect_files([PKG], REPO)


def _trace_analysis(program):
    import tools.dflint.tracerules as tr

    saved = tr.CONTRACTS_RELPATH
    tr.CONTRACTS_RELPATH = CONTRACTS_RELPATH
    try:
        return tr.TraceAnalysis(program, REPO)
    finally:
        tr.CONTRACTS_RELPATH = saved


@pytest.fixture(scope="module")
def program():
    return Program.from_paths([PKG], REPO)


def _contracts():
    tree = ast.parse((REPO / CONTRACTS_RELPATH).read_text())
    (value,) = [s.value for s in tree.body
                if isinstance(s, ast.Assign) and s.targets[0].id == "CONTRACTS"]
    return ast.literal_eval(value)


@pytest.mark.parametrize(
    "path", SOURCE_FILES,
    ids=[p.resolve().relative_to(REPO).as_posix() for p in SOURCE_FILES],
)
def test_dflint_clean(path):
    module = load_module(path, REPO)
    findings = run_checkers(module, [CHECKERS_BY_RULE[r] for r in RULES])
    assert not findings, "\n".join(f.render() for f in findings)


def test_whole_program_rules_clean(program):
    findings = program.findings() + _trace_analysis(program).findings()
    assert {f.rule for f in findings} <= set(PROGRAM_RULES)
    assert not findings, "\n".join(f.render() for f in findings)


def test_the_lint_covers_the_new_modules():
    rels = {p.resolve().relative_to(REPO).as_posix() for p in SOURCE_FILES}
    for rel in ("sim/qos.py", "sim/telemetry.py", "bench/fleet_assemble.py",
                "bench/bench_qos.py", "utils/dflock.py", "utils/dfspan.py",
                "utils/dfcrash.py", "utils/dfdet.py", "utils/dftrace.py",
                "records/contracts.py", "records/state_contracts.py",
                "records/determinism_contracts.py"):
        assert f"dragonfly2_tpu_torch/{rel}" in rels


def test_widened_slot_matrix_fails_df012():
    """The DF012 half can fail: the slot matrix created as float64."""
    fc = load_module(PKG / "scheduler" / "featcache.py", REPO)
    line = "self._matrix = np.zeros((max_hosts, HOST_FEATURE_DIM), dtype=np.float32)"
    assert line in fc.source
    mutant = Module(fc.path, fc.relpath, fc.source.replace(line, line.replace("32", "64")))
    contracts = load_module(REPO / CONTRACTS_RELPATH, REPO)
    assert _trace_analysis(Program([contracts, fc])).findings() == []
    hits = _trace_analysis(Program([contracts, mutant])).findings()
    assert [f.rule for f in hits] == ["DF012"] and "HostFeatureCache._matrix" in hits[0].message


def test_contract_functions_exist(program):
    for name, entry in _contracts().items():
        for fn in entry.get("functions", []) + list(entry.get("outputs", {})):
            assert f"{entry['file']}:{fn}" in program.funcs, (name, fn)


def test_download_columns_are_the_declared_list():
    from dragonfly2_tpu_torch.records import features

    c = _contracts()
    assert list(features.DOWNLOAD_COLUMNS) == c["dfc1.download"]["columns"]
    assert list(features.TOPO_COLUMNS) == c["dfc1.topology"]["columns"]


def test_slot_matrix_is_declared_shape_and_dtype():
    from dragonfly2_tpu_torch.scheduler import HostFeatureCache

    entry = _contracts()["featcache.slots"]
    cache = HostFeatureCache(max_hosts=64)
    _, snap = cache.matrix_snapshot()
    assert snap.dtype == np.dtype(entry["attrs"]["HostFeatureCache._matrix"])
    assert list(snap.shape) == [64, entry["shape"][1]]


def test_plain_kernels_return_declared_dtypes():
    from dragonfly2_tpu_torch.ops import fused_score, segment
    from dragonfly2_tpu_torch.ops.fused_score import (
        RULE_COMPONENT_WEIGHTS,
        ServingMLP,
        _fused_score_plain,
        _rule_sum_plain,
    )

    c = _contracts()
    rng = np.random.default_rng(0)
    dims = (32, 64, 64, 1)
    weights = [((rng.standard_normal((a, b)) * 0.3).astype(np.float32),
                (rng.standard_normal(b) * 0.05).astype(np.float32))
               for a, b in zip(dims[:-1], dims[1:])]
    mlp = ServingMLP(weights, device="cpu")
    mat = torch.from_numpy(rng.standard_normal((16, 12)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, 16, 9).astype(np.int32))
    dslots = torch.from_numpy(rng.integers(0, 16, 9).astype(np.int32))
    edge = torch.from_numpy(rng.standard_normal((9, 8)).astype(np.float32))
    comps = torch.from_numpy(rng.standard_normal((9, 6)).astype(np.float32))
    out = {
        "fused_gather_mlp_score": fused_score.fused_gather_mlp_score(mat, slots, dslots, edge, mlp),
        "_fused_score_plain": _fused_score_plain(mat, slots, dslots, edge, mlp.w0c, mlp.w0p,
                                                 mlp.w0e, mlp.b0, mlp.layers()),
        "rule_sum": fused_score.rule_sum(comps),
        "_rule_sum_plain": _rule_sum_plain(comps, RULE_COMPONENT_WEIGHTS),
    }
    for fn, dtype in c["ops.fused_score"]["outputs"].items():
        assert out[fn].dtype == getattr(torch, dtype), fn
        assert out[fn].shape == (9,), fn

    n_nodes, d = 12, 5
    dst = np.sort(rng.integers(0, n_nodes, 40)).astype(np.int64)
    values = torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32))
    plan = segment.build_plan(dst, n_nodes, device="cpu")
    seg = {
        "segment_sum_bucketed": segment.segment_sum_bucketed(values, plan, exact=True),
        "_segment_sum_plain": segment._segment_sum_plain(values, plan, exact=True,
                                                         presorted=False),
    }
    for fn, dtype in c["ops.segment_sum"]["outputs"].items():
        assert seg[fn].dtype == getattr(torch, dtype), fn
        assert seg[fn].shape == (n_nodes, d), fn
    # bf16 values accumulate to the declared float32.
    bf16 = segment.segment_sum_bucketed(values.to(torch.bfloat16), plan, exact=False)
    assert bf16.dtype == getattr(torch, c["ops.segment_sum"]["outputs"]["segment_sum_bucketed"])
