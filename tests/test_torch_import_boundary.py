"""The port's import boundary: ``dragonfly2_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package
``dragonfly2_tpu`` (not even its jax-free modules), nor the repo's
``tools/`` (whose ``fleet_assemble.py`` imports the JAX package: the
port keeps its own copy under ``bench/``).

Three checks: a static AST scan of every module's imports, a scan of
every string constant for a name of a ``dragonfly2_tpu.`` module (a
``python -m`` spawn or an ``importlib`` target that no import scan sees),
and a subprocess that imports the port's entry points with ``jax``,
``dragonfly2_tpu``, ``grpc`` and ``google`` made unimportable: the entry
points and ``chip_smoke.py`` need neither ``grpc`` nor ``protobuf``.  The gRPC half is
the one exception to the torch/numpy/stdlib rule: ``grpc`` and
``google.protobuf`` may be imported only by ``rpc/grpc_transport.py``,
``rpc/protos/*`` and ``rpc/ratelimit_grpc.py`` (the lazy interceptor),
and ``rpc.SchedulerGRPCServer`` then raises an ``ImportError`` naming
``grpc``.  ``cryptography`` is imported only by ``security/ca.py``, as in
the reference, and ``security/__init__`` gates it: with the package
unimportable the token half, the manager and the binaries still import,
and the CA surface is ``None``.  Last, the port's native library is its own: loaded in such a
subprocess, it lies under ``build/dragonfly2_tpu_torch_native/`` and the
JAX package's ``libdragonfly_native.so`` is never mapped.
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "dragonfly2_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "dragonfly2_tpu", "tools")


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


_GRPC_ROOTS = ("grpc", "google")
_GRPC_MODULES = ("dragonfly2_tpu_torch/rpc/grpc_transport.py",
                 "dragonfly2_tpu_torch/rpc/ratelimit_grpc.py",
                 "dragonfly2_tpu_torch/rpc/protos/")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_grpc_and_protobuf_only_in_the_grpc_modules(path):
    rel = str(path.relative_to(REPO))
    tree = ast.parse(path.read_text(), filename=str(path))
    grpc = sorted({n for n in _imported_roots(tree) if n.split(".")[0] in _GRPC_ROOTS})
    if rel.startswith(_GRPC_MODULES):
        return
    assert not grpc, f"{rel} imports {grpc}"


_JAX_MODULE_NAME = re.compile(r"(?<![\w.])dragonfly2_tpu\.[A-Za-z_]")


def _docstring_nodes(tree):
    """The docstring constants of the module, its classes and functions:
    prose about the reference, which names its modules by design."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_no_string_names_a_jax_package_module(path):
    """A string such as ``"dragonfly2_tpu.cli.dfdaemon"`` in a spawn's argv
    would run the JAX package's code with no import the scan above sees.
    Docstrings may cite the reference's files; no other string may name a
    ``dragonfly2_tpu.`` module (``dragonfly2_tpu_torch.`` is the port's)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = _docstring_nodes(tree)
    bad = [
        (node.lineno, node.value) for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docs and _JAX_MODULE_NAME.search(node.value)
    ]
    assert not bad, f"{path.name}: strings naming a JAX package module: {bad}"


_BLOCKED_IMPORT = """
import importlib.abc, sys

# Namespace-package .pth files may have made google.* before this line.
preloaded = set(sys.modules)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {roots!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
for name in {grpc_roots!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import importlib
importlib.import_module({module!r})
leaked = sorted(m for m in sys.modules if m not in preloaded
                and m.split(".")[0] in {roots!r} and sys.modules[m] is not None)
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
        "dragonfly2_tpu_torch.bench.k2_ladder",
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
        "dragonfly2_tpu_torch.cli.dfdaemon",
        "dragonfly2_tpu_torch.cli.dfget",
        "dragonfly2_tpu_torch.daemon",
        "dragonfly2_tpu_torch.rpc.piece_transport",
        "dragonfly2_tpu_torch.rpc.daemon_control",
        "dragonfly2_tpu_torch.source",
        "dragonfly2_tpu_torch.bench.peer_swarm",
        "dragonfly2_tpu_torch.cli.manager",
        "dragonfly2_tpu_torch.jobs",
        "dragonfly2_tpu_torch.jobs.remote",
        "dragonfly2_tpu_torch.manager.dynconfig",
        "dragonfly2_tpu_torch.manager.crud",
        "dragonfly2_tpu_torch.daemon.seeder",
        "dragonfly2_tpu_torch.scheduler.seed_client",
        "dragonfly2_tpu_torch.bench.preheat_swarm",
        "dragonfly2_tpu_torch.scheduler.sharding",
        "dragonfly2_tpu_torch.rpc.resolver",
        "dragonfly2_tpu_torch.rpc.steering",
        "dragonfly2_tpu_torch.sim.fleet",
        "dragonfly2_tpu_torch.sim.chaos",
        "dragonfly2_tpu_torch.bench.fleet_swarm",
        "dragonfly2_tpu_torch.bench.shard_fleet",
        "dragonfly2_tpu_torch.native",
        "dragonfly2_tpu_torch.utils.dfabi",
        "dragonfly2_tpu_torch.records.abi_contracts",
        "dragonfly2_tpu_torch.scheduler.push",
        "dragonfly2_tpu_torch.utils.diagnostics",
        "dragonfly2_tpu_torch.rpc.ratelimit",
        "dragonfly2_tpu_torch.cli.common",
        "dragonfly2_tpu_torch.bench.k1_replay",
        "dragonfly2_tpu_torch.sim.qos",
        "dragonfly2_tpu_torch.sim.telemetry",
        "dragonfly2_tpu_torch.bench.fleet_assemble",
        "dragonfly2_tpu_torch.bench.bench_qos",
        "dragonfly2_tpu_torch.utils.dflock",
        "dragonfly2_tpu_torch.utils.dfspan",
        "dragonfly2_tpu_torch.utils.dfcrash",
        "dragonfly2_tpu_torch.utils.dfdet",
        "dragonfly2_tpu_torch.utils.dftrace",
        "dragonfly2_tpu_torch.records.contracts",
        "dragonfly2_tpu_torch.records.state_contracts",
        "dragonfly2_tpu_torch.records.determinism_contracts",
        "dragonfly2_tpu_torch.daemon.proxy",
        "dragonfly2_tpu_torch.daemon.relay",
        "dragonfly2_tpu_torch.daemon.gateway",
        "dragonfly2_tpu_torch.daemon.pex_net",
        "dragonfly2_tpu_torch.objectstorage",
        "dragonfly2_tpu_torch.objectstorage.s3",
        "dragonfly2_tpu_torch.cli.dfstore",
        "dragonfly2_tpu_torch.cli.dfcache",
        "dragonfly2_tpu_torch.parallel.launch",
        "dragonfly2_tpu_torch.security",
        "dragonfly2_tpu_torch.security.tokens",
        "dragonfly2_tpu_torch.security.ca",
        "dragonfly2_tpu_torch.security.tls",
        "dragonfly2_tpu_torch.daemon.sni",
        "dragonfly2_tpu_torch.rpc.vsock",
        "dragonfly2_tpu_torch.manager.users",
        "dragonfly2_tpu_torch.manager.oauth",
        "dragonfly2_tpu_torch.manager.console",
        "dragonfly2_tpu_torch.manager.openapi",
        "dragonfly2_tpu_torch.bench.secure_cluster",
        "dragonfly2_tpu_torch.manager.replication",
        "dragonfly2_tpu_torch.utils.cache",
        "dragonfly2_tpu_torch.utils.plugin",
        "dragonfly2_tpu_torch.tools.stress",
        "dragonfly2_tpu_torch.version",
        "dragonfly2_tpu_torch.bench.manager_failover",
        "chip_smoke",
    ],
)
def test_entry_points_import_with_the_jax_package_blocked(module):
    code = _BLOCKED_IMPORT.format(roots=_FORBIDDEN_ROOTS + _GRPC_ROOTS, repo=str(REPO),
                                  module=module, grpc_roots=_GRPC_ROOTS)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(REPO),
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_cryptography_only_in_the_ca_module(path):
    rel = str(path.relative_to(REPO))
    tree = ast.parse(path.read_text(), filename=str(path))
    crypto = sorted({n for n in _imported_roots(tree) if n.split(".")[0] == "cryptography"})
    if rel == "dragonfly2_tpu_torch/security/ca.py":
        assert crypto
        return
    assert not crypto, f"{rel} imports {crypto}"


_NO_CRYPTOGRAPHY = """
import sys
sys.modules["cryptography"] = None
sys.path.insert(0, {repo!r})
import dragonfly2_tpu_torch.security as sec
assert sec.CertificateAuthority is None and sec.PeerIdentity is None
assert sec.client_context is None and sec.server_context is None
tok = sec.TokenIssuer(b"0123456789abcdef0123").issue("d", sec.Role.PEER)
assert sec.TokenVerifier(b"0123456789abcdef0123").verify(tok).subject == "d"
import dragonfly2_tpu_torch.manager.rest
import dragonfly2_tpu_torch.cli.manager
import dragonfly2_tpu_torch.cli.scheduler
import dragonfly2_tpu_torch.cli.dfdaemon
print("OK")
"""


def test_token_half_and_binaries_import_without_cryptography():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_CRYPTOGRAPHY.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


_NATIVE_LOAD = """
import os
from dragonfly2_tpu_torch import native
from dragonfly2_tpu_torch.utils import dfabi
lib = native.load()
assert lib is not None, native.build_error()
assert dfabi.compare() == [], dfabi.compare()
maps = open("/proc/self/maps").read()
print(native.lib_path)
print("jax-library-mapped" if "dragonfly2_tpu/native/libdragonfly_native" in maps else "own")
"""


_GRPC_NAMES = """
from dragonfly2_tpu_torch import rpc
from dragonfly2_tpu_torch.rpc import ratelimit
for owner, name in ((rpc, "SchedulerGRPCServer"), (ratelimit, "RateLimitInterceptor")):
    try:
        getattr(owner, name)
    except ImportError as exc:
        assert "grpc" in str(exc) and exc.name == "grpc", (name, exc, exc.name)
    else:
        raise AssertionError(name + " resolved without grpc")
print("OK")
"""


def test_grpc_names_raise_an_import_error_naming_grpc_without_it():
    code = _BLOCKED_IMPORT.format(roots=_FORBIDDEN_ROOTS + _GRPC_ROOTS, repo=str(REPO),
                                  module="dragonfly2_tpu_torch.rpc", grpc_roots=_GRPC_ROOTS)
    code = code.replace('print("OK")', _GRPC_NAMES)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


def test_the_native_library_is_the_ports_own_build():
    code = _BLOCKED_IMPORT.format(roots=_FORBIDDEN_ROOTS, repo=str(REPO),
                                  module="dragonfly2_tpu_torch.native", grpc_roots=())
    code = code.replace('print("OK")', _NATIVE_LOAD)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    path, mapped = proc.stdout.split()
    assert Path(path).parent == REPO / "build" / "dragonfly2_tpu_torch_native"
    assert Path(path).name.startswith("libdragonfly_native_") and Path(path).is_file()
    assert mapped == "own"
