"""Dynamic lock witness: runtime validation of the static lock graph.

``tools/dflint/program.py`` derives the project's lock-ordering graph by
static analysis.  Static resolution can rot silently — a call-graph edge
the resolver misses removes lock edges from the graph without failing
anything.  This module closes that loop: in witness mode (installed by
the port's witness child, ``tests/_torch_witness_child.py``) every ``threading.Lock`` /
``RLock`` / ``Condition`` **created from project code** is wrapped in a
recording proxy.  Each thread keeps a stack of held locks; acquiring
lock B while holding lock A records the acquisition-order edge A→B,
keyed by the locks' *creation sites* ``(relpath, lineno)`` — exactly the
identity the static analyzer records for every ``threading.X()`` call,
so dynamic edges map 1:1 onto static lock classes.

The cross-check (``tests/test_torch_witnesses.py``) then asserts
that every dynamically-observed edge exists in the statically-derived
graph: a dynamic edge with no static counterpart means the resolver has
a blind spot (test failure, not silent rot).

Design constraints:

- **foreign locks are untouched** — the factory wraps only when the
  creating frame's file lives under the package root; torch, logging,
  queue, Event internals keep raw primitives and zero overhead;
- **Condition waits are modeled exactly** — a no-arg ``Condition`` gets
  a proxied RLock as its backing lock, and the proxy hides
  ``_release_save``/``_acquire_restore`` so ``Condition.wait`` releases
  and re-acquires through the recording ``release()``/``acquire()``
  path (the held-stack correctly drops the lock while waiting);
- **recording failure never breaks locking** — the proxy's bookkeeping
  is wrapped defensively; the underlying primitive's semantics are
  delegated untouched.

Port of ``dragonfly2_tpu/utils/dflock.py``, with the logic verbatim,
installed on ``dragonfly2_tpu_torch/``: only locks whose creating frame
lies under the port's package are wrapped.  ``tests/conftest.py``
installs the reference's witnesses only; the port's witness tests
install this one in a child interpreter, before any port import.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

Site = Tuple[str, int]          # (repo-relative path, lineno) of the creation call
EdgeKey = Tuple[Site, Site]


class LockWitness:
    """Global edge recorder shared by every proxy."""

    def __init__(self, package_dir: str) -> None:
        self.package_dir = os.path.abspath(package_dir)
        self.repo_root = os.path.dirname(self.package_dir)
        self._mu = _REAL_LOCK()
        self._local = threading.local()
        # edge -> description of the first observation (thread + location)
        self.edges: Dict[EdgeKey, str] = {}
        self.sites: Set[Site] = set()

    # -- creation-site capture ----------------------------------------------

    def site_of_frame(self, frame) -> Optional[Site]:
        filename = os.path.abspath(frame.f_code.co_filename)
        if not filename.startswith(self.package_dir + os.sep):
            return None
        rel = os.path.relpath(filename, self.repo_root).replace(os.sep, "/")
        return (rel, frame.f_lineno)

    # -- held-stack bookkeeping ---------------------------------------------

    def _stack(self) -> List[Site]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def note_acquire(self, site: Site) -> None:
        st = self._stack()
        if st:
            new = [
                (held, site) for held in dict.fromkeys(st)
                if (held, site) not in self.edges
            ]
            if new:
                frame = sys._getframe(2)
                where = (
                    f"{threading.current_thread().name} at "
                    f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
                )
                with self._mu:
                    for key in new:
                        self.edges.setdefault(key, where)
        st.append(site)

    def note_release(self, site: Site) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == site:
                del st[i]
                return

    def snapshot_edges(self) -> Dict[EdgeKey, str]:
        with self._mu:
            return dict(self.edges)

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()


class _WitnessProxy:
    """Records acquire/release around a real Lock/RLock; everything else
    (``locked``, ``_is_owned``, …) delegates to the primitive.
    ``_release_save``/``_acquire_restore`` are deliberately HIDDEN so a
    ``Condition`` backed by this proxy falls back to plain
    ``release()``/``acquire()`` during ``wait()`` — keeping the recorded
    held-stack exact across waits."""

    __slots__ = ("_inner", "_site", "_w")

    def __init__(self, inner, site: Site, witness: LockWitness) -> None:
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_site", site)
        object.__setattr__(self, "_w", witness)

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            try:
                self._w.note_acquire(self._site)
            except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; the lock itself IS acquired and a raise here would corrupt callers' locking
                pass
        return got

    def release(self):
        self._inner.release()
        try:
            self._w.note_release(self._site)
        except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; the lock is already released and a raise here would corrupt callers' locking
            pass

    def __enter__(self):
        return self.acquire()

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        if name in ("_release_save", "_acquire_restore"):
            # Force threading.Condition onto the recording fallback path.
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __repr__(self):  # pragma: no cover — debugging aid
        return f"<dflock proxy {self._site[0]}:{self._site[1]} of {self._inner!r}>"


_installed: Optional[LockWitness] = None


def witness() -> Optional[LockWitness]:
    return _installed


def _default_package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def install(package_dir: Optional[str] = None) -> LockWitness:
    """Patch the ``threading`` factories with site-aware wrappers.
    Idempotent; returns the active witness."""
    global _installed
    if _installed is not None:
        return _installed
    w = LockWitness(package_dir or _default_package_dir())

    def make_lock():
        site = w.site_of_frame(sys._getframe(1))
        inner = _REAL_LOCK()
        if site is None:
            return inner
        w.sites.add(site)
        return _WitnessProxy(inner, site, w)

    def make_rlock():
        site = w.site_of_frame(sys._getframe(1))
        inner = _REAL_RLOCK()
        if site is None:
            return inner
        w.sites.add(site)
        return _WitnessProxy(inner, site, w)

    def make_condition(lock=None):
        site = w.site_of_frame(sys._getframe(1))
        if site is None:
            return _REAL_CONDITION(lock)
        if lock is None:
            # Same default as stock Condition (an RLock), but proxied so
            # enter/exit/wait record against THIS creation site.
            w.sites.add(site)
            lock = _WitnessProxy(_REAL_RLOCK(), site, w)
        # An explicit lock is (usually) already a proxy recording against
        # its own creation site — Condition acquisitions alias it, which
        # matches the static analyzer's Condition(wrapped-lock) model.
        return _REAL_CONDITION(lock)

    threading.Lock = make_lock
    threading.RLock = make_rlock
    threading.Condition = make_condition
    _installed = w
    return w


def uninstall() -> None:
    """Restore the stock factories (existing proxies keep working)."""
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    _installed = None
