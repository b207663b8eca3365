"""Dynamic crash witness: runtime validation of the persistence inventory.

``tools/dflint/staterules.py`` (DF014) statically inventories every
KVTable write site — (namespace, callsite, method) — and declares which
sites are multi-row transactions that must stay ONE ``put_many``.
Static analysis can rot silently: a binding the resolver misses, or a
``put_many`` quietly split into sequential ``put``s, changes nothing in
the lint until the wrong crash tears an invariant.  This module closes
that loop, in the mould of the lock witness (``utils/dflock.py``) and
the compile witness (``utils/dftrace.py``):

in witness mode (installed by the port's witness child) every write method
on the concrete ``KVTable`` implementations (``_MemTable`` /
``_SQLiteTable``) records, for writes issued **from project code**, the
triple ``(namespace, caller site, method, row count)`` keyed by the
caller's ``(relpath, lineno)`` — exactly the identity the static
persistence inventory indexes.

``tests/test_torch_witnesses.py`` then asserts that every observed
write site maps into :meth:`StateAnalysis.persistence_site_index` with
the same namespace (a stale inventory is a test failure, not silent
rot), that the declared multi-row sites are only ever observed as
``put_many``, and — driving the existing ``state.put.*`` fault seams —
that a crash injected at each declared multi-row site leaves the
namespace's declared invariant intact after reload.

Design constraints, mirroring dflock/dftrace:

- **foreign writes are untouched** — a table driven directly from test
  code records nothing (only project-code callers are inventoried);
- **recording is re-entrant-safe** — ``_SQLiteTable.put`` delegates to
  ``put_many``; a thread-local depth guard attributes the write to the
  OUTERMOST call, with the method name the caller actually issued;
- **recording failure never breaks persistence** — bookkeeping is
  wrapped defensively; the underlying write always runs.

Port of ``dragonfly2_tpu/utils/dfcrash.py``, with the logic verbatim,
installed on ``dragonfly2_tpu_torch/`` (the port's ``manager/state.py``
tables).  The static side it is held to is built from the port's own
``records/state_contracts.py``; the crash seams are the port's
``state.put.*`` faults.  The port's witness tests install it in a child
interpreter (``tests/conftest.py`` installs the reference's only).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

Site = Tuple[str, int]          # (repo-relative path, lineno) of the caller


def _raw_lock():
    """The witness's own bookkeeping lock, built from the REAL lock
    factory: diagnostics must not instrument diagnostics.  A proxied
    lock here would put consumer-lock → witness-lock edges into the
    lock witness's graph that no static analysis can explain (the
    table-method wrapping only exists at runtime)."""
    try:
        from .dflock import _REAL_LOCK

        return _REAL_LOCK()
    except ImportError:  # pragma: no cover — dflock always ships
        return threading.Lock()


class WriteStats:
    __slots__ = ("namespace", "method", "writes", "max_rows")

    def __init__(self, namespace: str, method: str) -> None:
        self.namespace = namespace
        self.method = method
        self.writes = 0
        self.max_rows = 0

    def as_dict(self) -> dict:
        return {
            "namespace": self.namespace,
            "method": self.method,
            "writes": self.writes,
            "max_rows": self.max_rows,
        }


class CrashWitness:
    """Global per-site write statistics."""

    def __init__(self, package_dir: str) -> None:
        self.package_dir = os.path.abspath(package_dir)
        self.repo_root = os.path.dirname(self.package_dir)
        self._mu = _raw_lock()
        self._local = threading.local()
        # site -> {(namespace, method): WriteStats}
        self.records: Dict[Site, Dict[Tuple[str, str], WriteStats]] = {}

    # -- caller-site capture ------------------------------------------------

    def _site_of_stack(self) -> Optional[Site]:
        """The project frame that issued the table write: walk up past
        this module and the KVTable implementations themselves."""
        frame = sys._getframe(2)
        own = os.path.abspath(__file__)
        while frame is not None:
            filename = os.path.abspath(frame.f_code.co_filename)
            if filename == own:
                frame = frame.f_back
                continue
            if filename.endswith(os.path.join("manager", "state.py")) and \
                    frame.f_code.co_name in ("put", "put_many", "delete"):
                # The _SQLiteTable.put → put_many internal hop.
                frame = frame.f_back
                continue
            if not filename.startswith(self.package_dir + os.sep):
                return None   # foreign caller (test driving the table raw)
            rel = os.path.relpath(filename, self.repo_root).replace(os.sep, "/")
            return (rel, frame.f_lineno)
        return None

    # -- recording ----------------------------------------------------------

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def _enter(self) -> int:
        d = self._depth()
        self._local.depth = d + 1
        return d

    def _exit(self) -> None:
        self._local.depth = max(self._depth() - 1, 0)

    def note_write(self, namespace: str, method: str, rows: int) -> None:
        site = self._site_of_stack()
        if site is None:
            return
        key = (namespace, method)
        with self._mu:
            per_site = self.records.setdefault(site, {})
            st = per_site.get(key)
            if st is None:
                st = per_site[key] = WriteStats(namespace, method)
            st.writes += 1
            if rows > st.max_rows:
                st.max_rows = rows

    def snapshot(self) -> Dict[Site, List[dict]]:
        with self._mu:
            return {
                site: [st.as_dict() for st in sorted(
                    per_site.values(), key=lambda s: (s.namespace, s.method)
                )]
                for site, per_site in self.records.items()
            }

    def reset(self) -> None:
        with self._mu:
            self.records.clear()


_installed: Optional[CrashWitness] = None


def witness() -> Optional[CrashWitness]:
    return _installed


class isolated:
    """``with isolated() as w: ...`` — scoped empty record table, the
    run's observations restored on exit.  The mutation-sensitivity
    test drives a deliberately-torn registry through the live witness;
    its records must not poison the run-wide inventory check."""

    def __enter__(self) -> Optional[CrashWitness]:
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


def _default_package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wrap(cls, name: str, w: CrashWitness) -> None:
    orig = cls.__dict__[name]

    if name == "put_many":
        def wrapped(self, items):                      # noqa: ANN001
            depth = w._enter()
            try:
                out = orig(self, items)
            finally:
                w._exit()
            # Committed writes only: an injected pre-transaction fault
            # must not surface as an observed write.
            if depth == 0:
                try:
                    w.note_write(getattr(self, "_ns", "?"), name, len(items))
                except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; the write itself already committed
                    pass
            return out
    else:
        def wrapped(self, key, *args):                 # noqa: ANN001
            depth = w._enter()
            try:
                out = orig(self, key, *args)
            finally:
                w._exit()
            if depth == 0:
                try:
                    w.note_write(getattr(self, "_ns", "?"), name, 1)
                except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; the write itself already committed
                    pass
            return out

    wrapped.__name__ = name
    wrapped.__qualname__ = f"{cls.__name__}.{name}"
    wrapped.__wrapped_by_dfcrash__ = orig
    setattr(cls, name, wrapped)


def install(package_dir: Optional[str] = None) -> CrashWitness:
    """Wrap the concrete KVTable write methods with recording shims.
    Idempotent; returns the active witness.  Importing the state module
    here is the point — the child installs dflock first, so the
    import itself is fully witnessed."""
    global _installed
    if _installed is not None:
        return _installed
    from ..manager import state

    w = CrashWitness(package_dir or _default_package_dir())
    for cls in (state._MemTable, state._SQLiteTable):
        for name in ("put", "put_many", "delete"):
            if not hasattr(cls.__dict__.get(name), "__wrapped_by_dfcrash__"):
                _wrap(cls, name, w)
    _installed = w
    return w


def uninstall() -> None:
    """Restore the stock write methods."""
    global _installed
    from ..manager import state

    for cls in (state._MemTable, state._SQLiteTable):
        for name in ("put", "put_many", "delete"):
            fn = cls.__dict__.get(name)
            orig = getattr(fn, "__wrapped_by_dfcrash__", None)
            if orig is not None:
                setattr(cls, name, orig)
    _installed = None
