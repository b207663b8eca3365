"""Runtime span witness: dynamic validation of DF016's span inventory.

``tools/dflint/checkers/df016_spans.py`` pins each instrumented module
to the span names it must open (static AST extraction).  Static checks
can rot without failing anything: a span site the extractor cannot see
(opened through an alias it doesn't recognize) silently leaves the
inventory unenforced, and an inventoried span whose call path the suite
no longer reaches may be "present" in the AST while never actually
recording.  This module closes the loop in the lock/compile/crash
witness mould (utils/dflock.py, utils/dftrace.py, utils/dfcrash.py):

- installed before the workloads run, it wraps
  ``Tracer.span`` / ``Tracer.remote_span`` so every span OPENED from
  project code records
  ``(caller relpath, span name, kind)``;
- ``tests/test_torch_witnesses.py`` then cross-validates: every
  inventoried site of every module the suite imported must have been
  observed at runtime (deleting a ``remote_span`` fails HERE as well as
  in the static rule), and every observed span must match a site the
  static extractor found in its module (an unmatched observation means
  the extractor has a blind spot — test failure, not silent rot).

Design constraints (mirroring dflock/dftrace/dfcrash):

- **foreign spans untouched** — only call sites whose frame lives under
  the package root record; tests and tools construct spans freely;
- **tracing.py's own frames are skipped** — ``remote_span`` delegates to
  ``span`` internally; recording that inner call would attribute every
  remote span to utils/tracing.py instead of its real opener;
- **recording failure never breaks tracing** — bookkeeping is wrapped
  defensively and the real contextmanager is always returned;
- the bookkeeping lock comes from dflock's REAL factory: diagnostics
  must not instrument diagnostics.

Set ``DF_SPAN_WITNESS=0`` to disable.

Port of ``dragonfly2_tpu/utils/dfspan.py``, with the logic verbatim,
installed on ``dragonfly2_tpu_torch/``.  The static side it is held to
is the port's own inventory, ``REQUIRED_SPANS`` below: DF016's table
(``tools/dflint/checkers/df016_spans.py``) entry for entry, keyed by the
port's relpaths, for the modules the port has.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, Tuple

Site = Tuple[str, str, str]   # (caller relpath, span name, kind)


def _raw_lock():
    try:
        from .dflock import _REAL_LOCK

        return _REAL_LOCK()
    except ImportError:  # pragma: no cover — dflock always ships
        return threading.Lock()


class SpanWitness:
    """Global recorder shared by the patched tracer methods."""

    def __init__(self, package_dir: str) -> None:
        self.package_dir = os.path.abspath(package_dir)
        self.repo_root = os.path.dirname(self.package_dir)
        self.tracing_relpath = (
            os.path.basename(self.package_dir) + "/utils/tracing.py"
        )
        self._mu = _raw_lock()
        self.observed: Dict[Site, int] = {}

    def note(self, frame, name: str, kind: str) -> None:
        filename = os.path.abspath(frame.f_code.co_filename)
        if not filename.startswith(self.package_dir + os.sep):
            return
        rel = os.path.relpath(filename, self.repo_root).replace(os.sep, "/")
        if rel == self.tracing_relpath:
            # remote_span's internal self.span() call — the outer
            # wrapper already recorded the real opener.
            return
        key = (rel, name, kind)
        with self._mu:
            self.observed[key] = self.observed.get(key, 0) + 1

    def snapshot(self) -> Dict[Site, int]:
        with self._mu:
            return dict(self.observed)

    def names_by_module(self) -> Dict[str, set]:
        out: Dict[str, set] = {}
        with self._mu:
            for (rel, name, _kind) in self.observed:
                out.setdefault(rel, set()).add(name)
        return out

    def reset(self) -> None:
        with self._mu:
            self.observed.clear()


_installed: Optional[SpanWitness] = None


def witness() -> Optional[SpanWitness]:
    return _installed


def _default_package_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def install(package_dir: Optional[str] = None) -> SpanWitness:
    """Wrap ``Tracer.span``/``Tracer.remote_span`` with recording
    shims.  Idempotent; returns the active witness."""
    global _installed
    if _installed is not None:
        return _installed
    from .tracing import Tracer

    w = SpanWitness(package_dir or _default_package_dir())
    real_span = Tracer.span
    real_remote = Tracer.remote_span

    def span(self, name, **kwargs):
        try:
            w.note(sys._getframe(1), name, "span")
        except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; tracing itself must proceed
            pass
        return real_span(self, name, **kwargs)

    def remote_span(self, name, traceparent, **kwargs):
        try:
            w.note(sys._getframe(1), name, "remote_span")
        except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; tracing itself must proceed
            pass
        return real_remote(self, name, traceparent, **kwargs)

    Tracer.span = span
    Tracer.remote_span = remote_span
    _installed = w
    return w


# DF016's inventory, entry for entry, keyed by the port's relpaths: each
# instrumented module and the span names it must open (f-string sites
# match on their constant prefix as ``prefix*``).  The reference's
# modules that the port does not have (ROADMAP item 14) have no entry.
REQUIRED_SPANS = {
    "dragonfly2_tpu_torch/rpc/scheduler_server.py": ("rpc/*",),
    "dragonfly2_tpu_torch/rpc/grpc_transport.py": ("rpc/*",),
    "dragonfly2_tpu_torch/daemon/conductor.py": (
        "daemon/download", "daemon/piece", "daemon/source.piece",
        "daemon/stream", "daemon/*",
    ),
    "dragonfly2_tpu_torch/daemon/piece_pipeline.py": ("daemon/report.flush",),
    "dragonfly2_tpu_torch/manager/rest.py": ("manager/GET", "manager/POST"),
    "dragonfly2_tpu_torch/jobs/preheat.py": (
        "jobs/preheat", "jobs/preheat.execute",
    ),
    "dragonfly2_tpu_torch/rollout/controller.py": ("rollout/transition",),
    "dragonfly2_tpu_torch/trainer/online_graph.py": ("trainer/dispatch",),
    "dragonfly2_tpu_torch/scheduler/microbatch.py": ("scheduler/eval.flush",),
    "dragonfly2_tpu_torch/scheduler/sharding.py": ("scheduler/shard.handoff",),
    "dragonfly2_tpu_torch/qos/autopilot.py": ("scheduler/qos.autopilot",),
    "dragonfly2_tpu_torch/lifecycle/daemon.py": (
        "lifecycle/epoch", "lifecycle/promote",
    ),
}
