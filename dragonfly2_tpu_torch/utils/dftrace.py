"""Dynamic shape witness: the port's counterpart of the compile witness.

The reference's ``utils/dftrace.py`` counts, per ``jax.jit`` creation
site, the XLA compiles one creation triggers, and its test holds
them to ``tools/dflint/compile_budget.toml``: a cached callable that
quietly starts retracing per call (shape churn) fails by function name.

This package has no jit.  What takes the place of a compile is the first
launch of each distinct padded shape through a cached device callable:
``FusedMLPScorer`` pads every flush to its candidate block and stages it
through ``_staging(n_pad)`` before K1 launches at that shape (on the
card, a new grid and, when the shape outgrows them, new pinned and
device staging buffers).  A scorer whose padding drifts per call pays
that on every flush.  In witness mode (``install()``; the port's witness
tests install it in a child interpreter, ``chip_smoke.py`` around its
QoS drill phase) each declared site in ``SHAPE_SITES`` is wrapped: the
creating method counts creations, and the shape method records the
distinct shapes each instance has launched.  Per site the witness keeps
creations, calls and the most distinct shapes any one instance reached
(``max_compiles``, the reference's name), and ``total_compiles()`` sums
that over sites, as the reference's does: ``scheduler/eval.flush``
carries it as ``jit_compiles`` (0 when no witness is installed).

Each site names the reference's budget key it answers to and carries the
port's copy of that bound (``budget``): 4 padded sizes per
``FusedMLPScorer``, as ``compile_budget.toml`` allows the reference's.

Design constraints, mirroring the reference's witnesses:

- **only project objects** — the wrappers sit on the port's own classes;
  nothing outside the package is touched;
- **recording failure never breaks the call** — bookkeeping is wrapped
  defensively and the real method always runs;
- the bookkeeping lock comes from dflock's REAL factory: diagnostics
  must not instrument diagnostics.
"""

from __future__ import annotations

import importlib
import threading
from typing import Any, Callable, Dict, Optional, Set

# site key "relpath:qual" of the creating method -> where its shapes are
# chosen, the reference's budget key and the port's copy of its bound.
SHAPE_SITES = {
    "dragonfly2_tpu_torch/ops/fused_score.py:FusedMLPScorer.__init__": {
        "module": "dragonfly2_tpu_torch.ops.fused_score",
        "class": "FusedMLPScorer",
        "create": "__init__",
        "shape": "_staging",
        "reference": "dragonfly2_tpu/ops/pallas_score.py:FusedMLPScorer.__init__",
        "budget": 4,
    },
}

_SHAPES_ATTR = "_dftrace_shapes"


def _raw_lock():
    try:
        from .dflock import _REAL_LOCK

        return _REAL_LOCK()
    except ImportError:  # pragma: no cover — dflock always ships
        return threading.Lock()


class SiteStats:
    __slots__ = ("creations", "calls", "max_compiles")

    def __init__(self) -> None:
        self.creations = 0
        self.calls = 0
        self.max_compiles = 0

    def as_dict(self) -> Dict[str, int]:
        return {
            "creations": self.creations,
            "calls": self.calls,
            "max_compiles": self.max_compiles,
        }


class ShapeWitness:
    """Per-site shape statistics shared by the wrapped methods."""

    def __init__(self) -> None:
        self._mu = _raw_lock()
        self.stats: Dict[str, SiteStats] = {}

    def _site(self, key: str) -> SiteStats:
        st = self.stats.get(key)
        if st is None:
            st = self.stats[key] = SiteStats()
        return st

    def note_creation(self, key: str) -> None:
        with self._mu:
            self._site(key).creations += 1

    def note_call(self, key: str, obj: Any, shape: Any) -> None:
        with self._mu:
            shapes: Optional[Set[Any]] = obj.__dict__.get(_SHAPES_ATTR)
            if shapes is None:
                # An instance made before the install: counted from its
                # first witnessed launch.
                shapes = obj.__dict__[_SHAPES_ATTR] = set()
                self._site(key).creations += 1
            shapes.add(shape)
            st = self._site(key)
            st.calls += 1
            if len(shapes) > st.max_compiles:
                st.max_compiles = len(shapes)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._mu:
            return {key: st.as_dict() for key, st in self.stats.items()}

    def total_compiles(self) -> int:
        """Sum of max-compiles over sites — a monotone proxy for 'a new
        shape launched since the last read'."""
        with self._mu:
            return sum(st.max_compiles for st in self.stats.values())

    def over_budget(self) -> Dict[str, Dict[str, int]]:
        """Sites whose busiest instance launched more shapes than the
        site's budget allows."""
        with self._mu:
            return {
                key: st.as_dict() for key, st in self.stats.items()
                if st.max_compiles > SHAPE_SITES[key]["budget"]
            }

    def reset(self) -> None:
        with self._mu:
            self.stats.clear()


def shapes_of(obj: Any) -> Set[Any]:
    """The distinct shapes one witnessed instance has launched."""
    return set(obj.__dict__.get(_SHAPES_ATTR, ()))


_installed: Optional[ShapeWitness] = None
_originals: Dict[tuple, Callable] = {}


def witness() -> Optional[ShapeWitness]:
    return _installed


def _wrap_create(key: str, orig: Callable, w: ShapeWitness) -> Callable:
    def wrapped(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        try:
            self.__dict__[_SHAPES_ATTR] = set()
            w.note_creation(key)
        except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; the object is already built
            pass

    wrapped.__name__ = orig.__name__
    wrapped.__qualname__ = orig.__qualname__
    wrapped.__doc__ = orig.__doc__
    return wrapped


def _wrap_shape(key: str, orig: Callable, w: ShapeWitness) -> Callable:
    def wrapped(self, shape, *args, **kwargs):
        try:
            w.note_call(key, self, shape)
        except Exception:  # dflint: disable=DF001 — diagnostics-only bookkeeping; the launch must proceed
            pass
        return orig(self, shape, *args, **kwargs)

    wrapped.__name__ = orig.__name__
    wrapped.__qualname__ = orig.__qualname__
    wrapped.__doc__ = orig.__doc__
    return wrapped


def install() -> ShapeWitness:
    """Wrap every declared site's creating and shape methods.
    Idempotent; returns the active witness."""
    global _installed
    if _installed is not None:
        return _installed
    w = ShapeWitness()
    for key, spec in SHAPE_SITES.items():
        cls = getattr(importlib.import_module(spec["module"]), spec["class"])
        for attr, wrap in ((spec["create"], _wrap_create), (spec["shape"], _wrap_shape)):
            orig = cls.__dict__[attr]
            _originals[(cls, attr)] = orig
            setattr(cls, attr, wrap(key, orig, w))
    _installed = w
    return w


def uninstall() -> None:
    """Restore the stock methods (witnessed instances keep their sets)."""
    global _installed
    for (cls, attr), orig in _originals.items():
        setattr(cls, attr, orig)
    _originals.clear()
    _installed = None
