"""The port's import boundary: ``dragonfly2_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package
``dragonfly2_tpu`` (not even its jax-free modules).

Two checks: a static AST scan of every module, and a subprocess that
imports the port's entry points with ``jax`` and ``dragonfly2_tpu``
made unimportable.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "dragonfly2_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "dragonfly2_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in _FORBIDDEN_ROOTS


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_module_imports_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
            "import_module", "__import__"
        ):
            bad += [
                a.value for a in node.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)
                and _forbidden(a.value)
            ]
    assert not bad, f"{path.name} imports {bad}"


_BLOCKED_IMPORT = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {roots!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import importlib
importlib.import_module({module!r})
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {roots!r} and sys.modules[m] is not None)
assert not leaked, leaked
print("OK")
"""


@pytest.mark.parametrize(
    "module",
    [
        "dragonfly2_tpu_torch.cli.scheduler",
        "dragonfly2_tpu_torch.ops.fused_score",
        "dragonfly2_tpu_torch.scheduler.service",
        "dragonfly2_tpu_torch.sim.swarm",
        "dragonfly2_tpu_torch.ops.segment",
        "dragonfly2_tpu_torch.trainer.train",
        "dragonfly2_tpu_torch.trainer.export",
        "dragonfly2_tpu_torch.bench.k1_stamps",
        "dragonfly2_tpu_torch.bench.timing",
        "dragonfly2_tpu_torch.trainer.streaming",
        "dragonfly2_tpu_torch.lifecycle.daemon",
        "dragonfly2_tpu_torch.scheduler.model_loader",
        "dragonfly2_tpu_torch.sim.lifecycle",
        "dragonfly2_tpu_torch.records.columnar",
        "dragonfly2_tpu_torch.records.csv_compat",
        "dragonfly2_tpu_torch.records.synthetic",
        "dragonfly2_tpu_torch.trainer.ingest",
        "dragonfly2_tpu_torch.trainer.service",
        "dragonfly2_tpu_torch.models.hop",
        "dragonfly2_tpu_torch.config",
        "dragonfly2_tpu_torch.cli.trainer",
        "dragonfly2_tpu_torch.bench.flagship",
        "dragonfly2_tpu_torch.scheduler.networktopology",
        "dragonfly2_tpu_torch.scheduler.evaluator",
        "dragonfly2_tpu_torch.records.storage",
        "dragonfly2_tpu_torch.sim",
        "dragonfly2_tpu_torch.models.gnn",
        "dragonfly2_tpu_torch.ops.transpose_gather",
        "dragonfly2_tpu_torch.trainer.online_graph",
        "dragonfly2_tpu_torch.trainer.federated",
        "dragonfly2_tpu_torch.bench.online_graph",
        "dragonfly2_tpu_torch.rpc",
        "dragonfly2_tpu_torch.rpc.cluster_client",
        "dragonfly2_tpu_torch.manager.rest",
        "dragonfly2_tpu_torch.scheduler.announcer",
        "dragonfly2_tpu_torch.scheduler.topology_sync",
        "dragonfly2_tpu_torch.bench.wire_loop",
        "dragonfly2_tpu_torch.rollout.client",
        "dragonfly2_tpu_torch.rollout.reporter",
        "chip_smoke",
    ],
)
def test_entry_points_import_with_the_jax_package_blocked(module):
    code = _BLOCKED_IMPORT.format(roots=_FORBIDDEN_ROOTS, repo=str(REPO), module=module)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr
