"""Dynamic determinism witness: runtime validation of the DF018 taint report.

``tools/dflint/detrules.py`` statically taints every function reachable
from a declared replay root (records/determinism_contracts.py) and
fails ambient nondeterminism inside the closure.  Static analysis can
rot silently: a call edge the resolver misses puts a ``time.time()``
back on a replay path with no finding.  This module closes that loop,
in the mould of the lock witness (``utils/dflock.py``), the compile
witness (``utils/dftrace.py``) and the crash witness
(``utils/dfcrash.py``):

in witness mode (installed by the port's witness child) the patchable ambient sources — ``time.time`` /
``monotonic`` / ``perf_counter`` (+ ``_ns`` twins), ``os.urandom``,
``uuid.uuid1``/``uuid4``, the ambient ``random`` module draws — are
wrapped with call-site recorders, and every declared replay root is
wrapped to ARM the recorder (thread-local) while it is on the stack.
Each ambient read observed while armed records ``(source, relpath,
lineno, root)`` — exactly the identity the static ambient-site index
uses.

``tests/test_torch_witnesses.py`` then asserts, via
:func:`tools.dflint.detrules.det_witness_gaps`, that every observation
maps to a statically-known ambient site or a declared observability
sink span (a resolver blind spot is a test failure, and a root the
contracts no longer declare fails the other direction); the QoS drill's
summary root is replayed under different PYTHONHASHSEED values in
subprocesses (``tests/test_torch_qos_drill.py``) — its output must be
byte-identical.

Design constraints, mirroring the sibling witnesses:

- **disarmed reads are near-free** — one thread-local attribute probe,
  then straight into the original function; other threads (journal
  cadence, exporter flush) stay disarmed while a root runs;
- **recording failure never breaks the plane** — bookkeeping is wrapped
  defensively; the underlying clock/RNG call always runs;
- **``datetime.datetime.now`` is NOT patchable** (attribute of a C
  type) — the static rule alone covers it, documented here so nobody
  mistakes its absence for coverage.

Port of ``dragonfly2_tpu/utils/dfdet.py``, with the logic verbatim,
installed on ``dragonfly2_tpu_torch/``: the roots it arms are the port's
``records/determinism_contracts.py``.  The port's witness tests install
it in a child interpreter (``tests/conftest.py`` installs the
reference's only).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple


def _raw_lock():
    """Bookkeeping lock from the REAL factory: diagnostics must not
    instrument diagnostics (the dfcrash/dftrace precedent)."""
    try:
        from .dflock import _REAL_LOCK

        return _REAL_LOCK()
    except ImportError:  # pragma: no cover — dflock always ships
        return threading.Lock()


# Ambient sources patched at module-attribute level.  Project code never
# does ``from time import time`` (dflint idiom), so attribute patches
# are visible everywhere.
_PATCHED_SOURCES: Tuple[Tuple[str, str, str], ...] = (
    # (module, attr, canonical source name — matches detrules' tables)
    ("time", "time", "time.time"),
    ("time", "time_ns", "time.time_ns"),
    ("time", "monotonic", "time.monotonic"),
    ("time", "monotonic_ns", "time.monotonic_ns"),
    ("time", "perf_counter", "time.perf_counter"),
    ("time", "perf_counter_ns", "time.perf_counter_ns"),
    ("os", "urandom", "os.urandom"),
    ("uuid", "uuid1", "uuid.uuid1"),
    ("uuid", "uuid4", "uuid.uuid4"),
    ("random", "random", "random.random"),
    ("random", "randint", "random.randint"),
    ("random", "randrange", "random.randrange"),
    ("random", "uniform", "random.uniform"),
    ("random", "choice", "random.choice"),
    ("random", "shuffle", "random.shuffle"),
    ("random", "getrandbits", "random.getrandbits"),
)


class DetWitness:
    """Armed-while-a-replay-root-runs ambient-read recorder."""

    def __init__(self, package_dir: str) -> None:
        self.package_dir = os.path.abspath(package_dir)
        self.repo_root = os.path.dirname(self.package_dir)
        self._mu = _raw_lock()
        self._local = threading.local()
        # (relpath, lineno, source, root) -> observation count
        self.records: Dict[Tuple[str, int, str, str], int] = {}

    # -- arming (thread-local root stack) -----------------------------------

    def _roots(self) -> List[str]:
        roots = getattr(self._local, "roots", None)
        if roots is None:
            roots = self._local.roots = []
        return roots

    def push_root(self, name: str) -> None:
        self._roots().append(name)

    def pop_root(self) -> None:
        roots = self._roots()
        if roots:
            roots.pop()

    def armed_root(self) -> Optional[str]:
        """The OUTERMOST armed root on this thread (build_report →
        replay_fleet → evaluate attributes to build_report), or None
        when disarmed."""
        roots = getattr(self._local, "roots", None)
        return roots[0] if roots else None

    def armed_depth(self) -> int:
        roots = getattr(self._local, "roots", None)
        return len(roots) if roots else 0

    # -- recording ----------------------------------------------------------

    def _site_of_stack(self) -> Optional[Tuple[str, int]]:
        """The nearest repo frame below the patched source: walk up
        past this module (and stdlib internals like ``uuid`` calling
        ``os.urandom``) to the project line that triggered the read."""
        frame = sys._getframe(2)
        own = os.path.abspath(__file__)
        while frame is not None:
            filename = os.path.abspath(frame.f_code.co_filename)
            if filename != own and filename.startswith(
                self.repo_root + os.sep
            ):
                rel = os.path.relpath(filename, self.repo_root)
                return (rel.replace(os.sep, "/"), frame.f_lineno)
            frame = frame.f_back
        return None

    def note_read(self, source: str) -> None:
        root = self.armed_root()
        if root is None:
            return
        site = self._site_of_stack()
        if site is None:
            return
        key = (site[0], site[1], source, root)
        with self._mu:
            self.records[key] = self.records.get(key, 0) + 1

    def snapshot(self) -> List[dict]:
        """Observations in det_witness_gaps' input shape."""
        with self._mu:
            return [
                {
                    "relpath": relpath,
                    "lineno": lineno,
                    "source": source,
                    "root": root,
                    "count": count,
                }
                for (relpath, lineno, source, root), count in sorted(
                    self.records.items()
                )
            ]

    def reset(self) -> None:
        with self._mu:
            self.records.clear()


_installed: Optional[DetWitness] = None


def witness() -> Optional[DetWitness]:
    return _installed


class isolated:
    """``with isolated() as w: ...`` — scoped empty record table, the
    run's observations restored on exit (the mutation-sensitivity
    drill must not poison the run-wide cross-validation)."""

    def __enter__(self) -> Optional[DetWitness]:
        w = _installed
        self._w = w
        if w is not None:
            with w._mu:
                self._saved, w.records = w.records, {}
        return w

    def __exit__(self, *exc) -> None:
        w = self._w
        if w is not None:
            with w._mu:
                w.records = self._saved
        return None


class armed:
    """``with armed("slo.evaluate"): ...`` — arm the recorder on this
    thread as if the named replay root were on the stack.  Test-only:
    the mutation drill compiles a deliberately-broken copy of a root's
    module and drives it under the root's name."""

    def __init__(self, root: str) -> None:
        self.root = root

    def __enter__(self) -> Optional[DetWitness]:
        w = _installed
        self._w = w
        if w is not None:
            w.push_root(self.root)
        return w

    def __exit__(self, *exc) -> None:
        if self._w is not None:
            self._w.pop_root()
        return None


def _default_package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- source + root wrapping --------------------------------------------------


def _wrap_source(orig: Callable, source: str, w: DetWitness) -> Callable:
    def wrapped(*args: Any, **kwargs: Any):
        # Disarmed fast path first: one thread-local probe, no locks.
        if w.armed_depth():
            try:
                w.note_read(source)
            except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; the read itself must run
                pass
        return orig(*args, **kwargs)

    wrapped.__name__ = getattr(orig, "__name__", source.rsplit(".", 1)[-1])
    wrapped.__qualname__ = wrapped.__name__
    wrapped.__wrapped_by_dfdet__ = orig
    return wrapped


def _wrap_root(name: str, fn: Callable, w: DetWitness) -> Callable:
    def wrapped(*args: Any, **kwargs: Any):
        w.push_root(name)
        try:
            return fn(*args, **kwargs)
        finally:
            w.pop_root()

    wrapped.__name__ = getattr(fn, "__name__", name)
    wrapped.__qualname__ = getattr(fn, "__qualname__", name)
    wrapped.__doc__ = getattr(fn, "__doc__", None)
    wrapped.__wrapped_by_dfdet__ = fn
    return wrapped


def _module_name_of(relpath: str) -> str:
    parts = relpath[:-3].split("/") if relpath.endswith(".py") else relpath.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _wrap_declared_roots(w: DetWitness) -> List[str]:
    """Wrap every declared replay root in place (module import is the
    resolution step — tools.* and dragonfly2_tpu.* are both packages).
    Returns the root names actually wrapped; an unresolvable root is
    skipped here because the static side already fails it by name."""
    import importlib

    from ..records.determinism_contracts import DETERMINISM_CONTRACTS

    wrapped_names: List[str] = []
    for name, spec in sorted(DETERMINISM_CONTRACTS["replay_roots"].items()):
        try:
            mod = importlib.import_module(_module_name_of(spec["file"]))
        except ImportError:
            continue
        qual = spec["qual"].split(".")
        if len(qual) == 1:
            holder: Any = mod
            attr = qual[0]
        else:
            holder = getattr(mod, qual[0], None)
            attr = qual[1]
            if holder is None:
                continue
        raw = holder.__dict__.get(attr) if isinstance(holder, type) else getattr(holder, attr, None)
        if raw is None:
            continue
        probe = raw.__func__ if isinstance(raw, (classmethod, staticmethod)) else raw
        if getattr(probe, "__wrapped_by_dfdet__", None) is not None:
            wrapped_names.append(name)
            continue
        # classmethod/staticmethod descriptors wrap their __func__ and
        # re-wrap in the same descriptor (SLOAutopilot.replay).
        if isinstance(raw, classmethod):
            shim: Any = classmethod(_wrap_root(name, raw.__func__, w))
            shim.__func__.__wrapped_by_dfdet__ = raw
        elif isinstance(raw, staticmethod):
            shim = staticmethod(_wrap_root(name, raw.__func__, w))
            shim.__func__.__wrapped_by_dfdet__ = raw
        else:
            shim = _wrap_root(name, raw, w)
        setattr(holder, attr, shim)
        wrapped_names.append(name)
    return wrapped_names


def install(package_dir: Optional[str] = None) -> DetWitness:
    """Patch the ambient sources and wrap the declared replay roots.
    Idempotent; returns the active witness."""
    global _installed
    if _installed is not None:
        return _installed
    import importlib

    w = DetWitness(package_dir or _default_package_dir())
    for mod_name, attr, source in _PATCHED_SOURCES:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr, None)
        if orig is None or getattr(orig, "__wrapped_by_dfdet__", None) is not None:
            continue
        setattr(mod, attr, _wrap_source(orig, source, w))
    w.wrapped_roots = _wrap_declared_roots(w)
    _installed = w
    return w


def uninstall() -> None:
    """Restore the stock sources and root functions."""
    global _installed
    import importlib

    for mod_name, attr, _source in _PATCHED_SOURCES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr, None)
        orig = getattr(fn, "__wrapped_by_dfdet__", None)
        if orig is not None:
            setattr(mod, attr, orig)
    if _installed is not None:
        from ..records.determinism_contracts import DETERMINISM_CONTRACTS

        for _name, spec in DETERMINISM_CONTRACTS["replay_roots"].items():
            try:
                mod = importlib.import_module(_module_name_of(spec["file"]))
            except ImportError:
                continue
            qual = spec["qual"].split(".")
            holder: Any = mod if len(qual) == 1 else getattr(mod, qual[0], None)
            if holder is None:
                continue
            attr = qual[-1]
            raw = holder.__dict__.get(attr) if isinstance(holder, type) else getattr(holder, attr, None)
            if isinstance(raw, (classmethod, staticmethod)):
                orig = getattr(raw.__func__, "__wrapped_by_dfdet__", None)
            else:
                orig = getattr(raw, "__wrapped_by_dfdet__", None)
            if orig is not None:
                setattr(holder, attr, orig)
    _installed = None
