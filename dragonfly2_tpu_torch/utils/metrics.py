"""Prometheus-style metrics registry (reference: scheduler/metrics/,
trainer/metrics/, grpc_prometheus interceptors).

Counters/gauges/histograms with label support and text exposition
(Prometheus format), dependency-free.  Services define their metric sets
at module scope the way the reference does (metrics.go:44-180).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline (exposition-format spec).  Without this a hostile
    label value (a URL with a quote, a multi-line error string) splits
    the sample line and corrupts every series after it in the scrape."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(v: str) -> str:
    """# HELP text escaping: backslash and newline only (quotes are legal
    in help text per the exposition format)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _current_trace_id() -> Optional[str]:
    """Active trace id on this thread (exemplar hook): one thread-local
    read through the tracer — cheap enough for per-observe use."""
    from .tracing import current_trace_id

    return current_trace_id()


class _Metric:
    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._mu = threading.Lock()

    def state(self) -> Optional[Dict[str, Any]]:
        """Serializable snapshot for the metric journal (DESIGN.md §23);
        None = this metric kind is not journaled."""
        return None

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        # Hot path (per-observe): equal length + every name present is
        # equivalent to set equality without building two sets per call.
        names = self.label_names
        if len(labels) == len(names):
            try:
                return tuple([labels[n] for n in names])
            except KeyError:
                pass
        raise ValueError(
            f"{self.name}: labels {sorted(labels)} != {sorted(self.label_names)}"
        )

    def _fmt_labels(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        inner = ",".join(
            f'{n}="{_escape_label_value(v)}"'
            for n, v in zip(self.label_names, key)
        )
        return "{" + inner + "}"


class _CounterChild:
    """Label-bound counter handle: the per-call kwargs-dict build and
    label validation are paid ONCE at bind time — serving hot paths
    (scheduler featcache/evaluator) observe through these."""

    __slots__ = ("_metric", "_key_t")

    def __init__(self, metric: "Counter", key: Tuple[str, ...]) -> None:
        self._metric = metric
        self._key_t = key

    def inc(self, amount: float = 1.0) -> None:
        m = self._metric
        with m._mu:
            m._values[self._key_t] = m._values.get(self._key_t, 0.0) + amount


class Counter(_Metric):
    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()) -> None:
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._mu:
            self._values[key] = self._values.get(key, 0.0) + amount

    def labels(self, **labels: str) -> _CounterChild:
        return _CounterChild(self, self._key(labels))

    def value(self, **labels: str) -> float:
        with self._mu:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}", f"# TYPE {self.name} counter"]
        with self._mu:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{self._fmt_labels(key)} {v}")
        return out

    def state(self) -> Dict[str, Any]:
        with self._mu:
            series = [[list(k), v] for k, v in sorted(self._values.items())]
        return {"type": "counter", "labels": list(self.label_names), "series": series}


class Gauge(_Metric):
    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()) -> None:
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._mu:
            self._values[self._key(labels)] = value

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._mu:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._mu:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}", f"# TYPE {self.name} gauge"]
        with self._mu:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{self._fmt_labels(key)} {v}")
        return out

    def state(self) -> Dict[str, Any]:
        with self._mu:
            series = [[list(k), v] for k, v in sorted(self._values.items())]
        return {"type": "gauge", "labels": list(self.label_names), "series": series}


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)


class _HistogramChild:
    """Label-bound histogram handle (see _CounterChild).  Caches the
    per-key bucket-count list so a hot-path observe is one bisect + one
    locked region of three list/dict ops."""

    __slots__ = ("_metric", "_key_t", "_counts")

    def __init__(self, metric: "Histogram", key: Tuple[str, ...]) -> None:
        self._metric = metric
        self._key_t = key
        self._counts = None

    def observe(self, value: float) -> None:
        m = self._metric
        idx = bisect.bisect_left(m.buckets, value)
        key = self._key_t
        tid = _current_trace_id()
        with m._mu:
            counts = self._counts
            if counts is None:
                counts = m._counts.get(key)
                if counts is None:
                    counts = m._counts[key] = [0] * len(m.buckets)
                self._counts = counts
            if idx < len(counts):
                counts[idx] += 1
            m._sums[key] = m._sums.get(key, 0.0) + value
            m._totals[key] = m._totals.get(key, 0) + 1
            if tid is not None:
                m._exemplars.setdefault(key, {})[idx] = tid


class Histogram(_Metric):
    def __init__(
        self,
        name: str,
        help: str,
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}
        # Exemplars: last trace id observed per (key, bucket) — recorded
        # under the existing metric lock (one dict store when a span is
        # active, nothing otherwise), exposed as /debug/exemplars JSON so
        # a slow-bucket latency joins to its flight-recorder trace.
        self._exemplars: Dict[Tuple[str, ...], Dict[int, str]] = {}

    def observe(self, value: float, **labels: str) -> None:
        # Counts are stored PER-BUCKET (one increment per observe) and
        # cumulated at expose time — the cumulative-update loop over the
        # bucket ladder showed up on the scheduler's per-announce path.
        self._observe_key(self._key(labels), value)

    def _observe_key(self, key: Tuple[str, ...], value: float) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        tid = _current_trace_id()
        with self._mu:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
            if idx < len(counts):
                counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if tid is not None:
                self._exemplars.setdefault(key, {})[idx] = tid

    def labels(self, **labels: str) -> "_HistogramChild":
        return _HistogramChild(self, self._key(labels))

    def exemplars(self) -> Dict[str, Dict[str, str]]:
        """``{label-set: {le: trace_id}}`` — the last trace id observed
        per bucket (``le`` is the bucket's upper bound, ``+Inf`` for the
        overflow bucket)."""
        with self._mu:
            snap = {k: dict(v) for k, v in self._exemplars.items()}
        out: Dict[str, Dict[str, str]] = {}
        for key, per_bucket in snap.items():
            label_str = self._fmt_labels(key) or "{}"
            out[label_str] = {
                (str(self.buckets[i]) if i < len(self.buckets) else "+Inf"): tid
                for i, tid in sorted(per_bucket.items())
            }
        return out

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}", f"# TYPE {self.name} histogram"]
        with self._mu:
            for key, counts in sorted(self._counts.items()):
                base = self._fmt_labels(key)[1:-1] if key else ""
                running = 0
                for le, c in zip(self.buckets, counts):
                    running += c
                    sep = "," if base else ""
                    out.append(f'{self.name}_bucket{{{base}{sep}le="{le}"}} {running}')
                sep = "," if base else ""
                out.append(f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {self._totals[key]}')
                lbl = "{" + base + "}" if base else ""
                out.append(f"{self.name}_sum{lbl} {self._sums[key]}")
                out.append(f"{self.name}_count{lbl} {self._totals[key]}")
        return out


# ---------------------------------------------------------------------------
# Mergeable percentile sketch (DESIGN.md §23)
# ---------------------------------------------------------------------------

# Process-wide sketch-recording toggle: the telemetry-overhead bench arm
# (tools/bench_sched.py) and operators who want fixed-bucket histograms
# only.  Mirrors tracing.set_enabled — disabled, observe() returns
# before touching the lock.
_SKETCHES_ENABLED = True


def set_sketches_enabled(on: bool) -> None:
    global _SKETCHES_ENABLED
    _SKETCHES_ENABLED = bool(on)


def sketches_enabled() -> bool:
    return _SKETCHES_ENABLED


# Values at or below this land in the zero bucket: latencies and sizes
# are non-negative, and log() needs a floor.
MIN_TRACKABLE = 1e-12


def sketch_state_quantile(st: Dict[str, Any], q: float) -> Optional[float]:
    """q-quantile estimate from a serialized sketch state, relative
    error ≤ alpha for positive values (the DDSketch midpoint bound:
    bucket i covers (γ^(i-1), γ^i]; 2γ^i/(γ+1) is within α of every
    value in it).  None on an empty sketch."""
    total = st["total"]
    if total <= 0:
        return None
    q = min(max(q, 0.0), 1.0)
    target = max(int(math.ceil(q * total)), 1)
    cum = st["zero"]
    if cum >= target:
        return 0.0
    gamma = (1.0 + st["alpha"]) / (1.0 - st["alpha"])
    value = 0.0
    for idx, c in sorted(st["counts"]):
        cum += c
        if cum >= target:
            value = 2.0 * gamma ** idx / (gamma + 1.0)
            break
    # The recorded extremes are exact; clamping costs nothing and keeps
    # p0/p100 honest.
    return min(max(value, st["min"]), st["max"])


def sketch_state_count_below(st: Dict[str, Any], threshold: float) -> float:
    """Samples ≤ threshold (resolved at sketch resolution: whole buckets
    whose upper bound γ^i does not exceed threshold·(1+α) count, so the
    answer is exact to within the declared relative error — the SLO
    engine's good-event source)."""
    if threshold <= MIN_TRACKABLE:
        return float(st["zero"])
    gamma = (1.0 + st["alpha"]) / (1.0 - st["alpha"])
    # Bucket of `threshold` itself: every bucket up to and including it
    # holds values ≤ threshold·(1+α).
    i_max = int(math.ceil(math.log(threshold) / math.log(gamma) - 1e-9))
    return float(st["zero"] + sum(c for idx, c in st["counts"] if idx <= i_max))


def merge_sketch_states(states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Lossless merge of serialized sketch states (same alpha): bucket
    counts add exactly, so merging per-process sketches equals having
    observed every sample in one sketch — the fleet-assembly primitive."""
    if not states:
        return {"alpha": 0.01, "zero": 0, "counts": [], "total": 0,
                "sum": 0.0, "min": 0.0, "max": 0.0}
    alpha = states[0]["alpha"]
    counts: Dict[int, int] = {}
    zero = total = 0
    total_sum = 0.0
    mn, mx = math.inf, -math.inf
    for st in states:
        if abs(st["alpha"] - alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different alpha "
                f"({st['alpha']} != {alpha})"
            )
        zero += st["zero"]
        total += st["total"]
        total_sum += st["sum"]
        if st["total"] > 0:
            mn = min(mn, st["min"])
            mx = max(mx, st["max"])
        for idx, c in st["counts"]:
            counts[idx] = counts.get(idx, 0) + c
    return {
        "alpha": alpha,
        "zero": zero,
        "counts": sorted(counts.items()),
        "total": total,
        "sum": total_sum,
        "min": mn if total > 0 else 0.0,
        "max": mx if total > 0 else 0.0,
    }


class _SketchSeries:
    """One label-set's bucket state (int bucket index → count)."""

    __slots__ = ("zero", "counts", "total", "sum", "mn", "mx")

    def __init__(self) -> None:
        self.zero = 0
        self.counts: Dict[int, int] = {}
        self.total = 0
        self.sum = 0.0
        self.mn = math.inf
        self.mx = -math.inf


class _SketchChild:
    """Label-bound sketch handle (see _CounterChild): label validation
    paid once at bind time — hot paths observe through these."""

    __slots__ = ("_metric", "_key_t")

    def __init__(self, metric: "Sketch", key: Tuple[str, ...]) -> None:
        self._metric = metric
        self._key_t = key

    def observe(self, value: float) -> None:
        if not _SKETCHES_ENABLED:
            return
        self._metric._observe_key(self._key_t, value)


class Sketch(_Metric):
    """DDSketch-style mergeable quantile sketch (relative-error bound).

    Buckets are logarithmic with ratio γ=(1+α)/(1−α): bucket i covers
    (γ^(i-1), γ^i], so any value's bucket-midpoint estimate is within α
    relative error.  The bucket index of a sample is a deterministic
    function of the value alone — two processes observing the same
    stream build byte-identical states, and ``merge_sketch_states`` adds
    counts exactly (lossless merge).  State is bounded: past ``max_bins``
    distinct buckets the lowest indices collapse into one (tail accuracy
    — the p99 the fleet cares about — is never what collapses).

    Exposed in the Prometheus text format as a ``summary`` (quantile
    label per series + _sum/_count), journaled exactly via ``state()``.
    """

    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Sequence[str] = (),
        alpha: float = 0.01,
        max_bins: int = 2048,
    ) -> None:
        super().__init__(name, help, label_names)
        if not (0.0 < alpha < 1.0):
            raise ValueError(f"sketch alpha {alpha} out of (0, 1)")
        self.alpha = alpha
        self.max_bins = max(16, max_bins)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self._series: Dict[Tuple[str, ...], _SketchSeries] = {}

    # -- recording -----------------------------------------------------------

    def observe(self, value: float, **labels: str) -> None:
        if not _SKETCHES_ENABLED:
            return
        self._observe_key(self._key(labels), value)

    def _observe_key(self, key: Tuple[str, ...], value: float) -> None:
        v = float(value)
        idx = (
            None if v <= MIN_TRACKABLE
            else int(math.ceil(math.log(v) / self._lg))
        )
        with self._mu:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _SketchSeries()
            if idx is None:
                s.zero += 1
            else:
                s.counts[idx] = s.counts.get(idx, 0) + 1
                if len(s.counts) > self.max_bins:
                    self._collapse_locked(s)
            s.total += 1
            s.sum += v
            if v < s.mn:
                s.mn = v
            if v > s.mx:
                s.mx = v

    def _collapse_locked(self, s: _SketchSeries) -> None:
        """Fold the lowest bucket indices together until the bin bound
        holds (DDSketch collapsing): the fine-grained tail — the high
        quantiles — keeps full resolution; only the smallest values get
        coarser."""
        keys = sorted(s.counts)
        floor_idx = keys[len(keys) - self.max_bins]
        folded = 0
        for k in keys:
            if k >= floor_idx:
                break
            folded += s.counts.pop(k)
        s.counts[floor_idx] = s.counts.get(floor_idx, 0) + folded

    def labels(self, **labels: str) -> _SketchChild:
        return _SketchChild(self, self._key(labels))

    # -- reading -------------------------------------------------------------

    def _state_of_locked(self, s: _SketchSeries) -> Dict[str, Any]:
        return {
            "alpha": self.alpha,
            "zero": s.zero,
            "counts": sorted(s.counts.items()),
            "total": s.total,
            "sum": s.sum,
            "min": s.mn if s.total else 0.0,
            "max": s.mx if s.total else 0.0,
        }

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        key = self._key(labels)
        with self._mu:
            s = self._series.get(key)
            if s is None:
                return None
            st = self._state_of_locked(s)
        return sketch_state_quantile(st, q)

    def count_below(self, threshold: float, **labels: str) -> float:
        key = self._key(labels)
        with self._mu:
            s = self._series.get(key)
            if s is None:
                return 0.0
            st = self._state_of_locked(s)
        return sketch_state_count_below(st, threshold)

    def total_count(self, **labels: str) -> int:
        key = self._key(labels)
        with self._mu:
            s = self._series.get(key)
            return s.total if s is not None else 0

    def aggregate_state(self) -> Dict[str, Any]:
        """All label series merged into one state — what an SLO over the
        whole metric (every parent, every task) evaluates against."""
        with self._mu:
            states = [self._state_of_locked(s) for s in self._series.values()]
        return merge_sketch_states(states)

    def state(self) -> Dict[str, Any]:
        with self._mu:
            series = [
                [list(k), self._state_of_locked(s)]
                for k, s in sorted(self._series.items())
            ]
        return {
            "type": "sketch",
            "labels": list(self.label_names),
            "alpha": self.alpha,
            "series": series,
        }

    def merge_state(self, st: Dict[str, Any], **labels: str) -> None:
        """Fold a serialized state into this sketch (tests / fleet
        tooling; not a hot path)."""
        key = self._key(labels)
        with self._mu:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _SketchSeries()
            own = self._state_of_locked(s)
        merged = merge_sketch_states([own, st])
        with self._mu:
            s.zero = merged["zero"]
            s.counts = dict(merged["counts"])
            s.total = merged["total"]
            s.sum = merged["sum"]
            s.mn = merged["min"] if merged["total"] else math.inf
            s.mx = merged["max"] if merged["total"] else -math.inf

    def expose(self) -> List[str]:
        out = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} summary",
        ]
        with self._mu:
            snap = [
                (k, self._state_of_locked(s))
                for k, s in sorted(self._series.items())
            ]
        for key, st in snap:
            base = self._fmt_labels(key)[1:-1] if key else ""
            sep = "," if base else ""
            for q in self.QUANTILES:
                v = sketch_state_quantile(st, q)
                if v is None:
                    continue
                out.append(
                    f'{self.name}{{{base}{sep}quantile="{q}"}} {v:.9g}'
                )
            lbl = "{" + base + "}" if base else ""
            out.append(f"{self.name}_sum{lbl} {st['sum']}")
            out.append(f"{self.name}_count{lbl} {st['total']}")
        return out


class Registry:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def counter(self, name: str, help: str = "", label_names: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, label_names))

    def gauge(self, name: str, help: str = "", label_names: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, label_names))

    def histogram(
        self,
        name: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram(name, help, label_names, buckets))

    def sketch(
        self,
        name: str,
        help: str = "",
        label_names: Sequence[str] = (),
        alpha: float = 0.01,
        max_bins: int = 2048,
    ) -> Sketch:
        return self._register(Sketch(name, help, label_names, alpha, max_bins))

    def get(self, name: str) -> Optional[_Metric]:
        with self._mu:
            return self._metrics.get(name)

    def _register(self, metric):
        with self._mu:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(f"metric {metric.name} re-registered as different type")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def expose_text(self) -> str:
        with self._mu:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """Serializable snapshot of every journaled metric — the metric
        journal's frame payload (utils/metric_journal.py, DESIGN.md §23):
        counters and gauges as (labels, value) series, sketches as exact
        bucket states.  Histograms are served by /metrics but not
        journaled (the sketch is the durable latency carrier).  Metric
        locks are taken one at a time, never nested under the registry
        lock (the expose_text discipline)."""
        with self._mu:
            metrics = list(self._metrics.values())
        out: Dict[str, Any] = {}
        for m in metrics:
            state = m.state()
            if state is not None:
                out[m.name] = state
        return out

    def exemplars(self) -> Dict[str, Dict[str, Dict[str, str]]]:
        """Every histogram's per-bucket exemplars (``/debug/exemplars``):
        {metric: {label-set: {le: trace_id}}}, empty sets omitted."""
        with self._mu:
            metrics = list(self._metrics.values())
        out: Dict[str, Dict[str, Dict[str, str]]] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                ex = m.exemplars()
                if ex:
                    out[m.name] = ex
        return out


# Process-default registry (services may create their own for isolation).
default_registry = Registry()
