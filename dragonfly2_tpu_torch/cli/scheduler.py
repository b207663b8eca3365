"""Scheduler composition root (reference: cmd/scheduler + scheduler/scheduler.go).

``build`` wires the serving half of the scheduler: resource managers,
the columnar host store, the evaluator for the configured algorithm (the
``ml`` one with cross-request scorer micro-batching), the scheduling
engine and the service.  With a scorer blob it installs the fused
gather+score scorer on ``device``, the way a model subscription would.

Record storage, the probe store, the seed trigger, the GC runner and the
transports are not part of this package yet.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..ops._build import resolve_device
from ..ops.fused_score import FusedMLPScorer
from ..scheduler import (
    HostFeatureCache,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
    ScorerBatcher,
    new_evaluator,
)
from ..trainer.export import load_scorer


class ConfigError(ValueError):
    pass


@dataclass
class SchedulingSection:
    """The ``scheduling`` fields ``build`` reads (config/schema.py in the
    reference package; same names and defaults)."""

    algorithm: str = "default"        # default | nt | ml (evaluator.go:28-46)
    candidate_parent_limit: int = 4
    filter_parent_limit: int = 15
    retry_limit: int = 5
    retry_back_to_source_limit: int = 4
    retry_interval_s: float = 0.5
    # Serving engine (ml algorithm, DESIGN.md §14): bounded linger the
    # cross-request micro-batcher waits to coalesce concurrent announce
    # evaluations into one padded scorer call (0 = flush immediately),
    # and the columnar host store's slot count.
    eval_batch_linger_ms: float = 1.5
    eval_feature_cache_hosts: int = 65536

    def validate(self) -> None:
        if self.algorithm not in ("default", "nt", "ml"):
            raise ConfigError(f"scheduling.algorithm {self.algorithm!r} unknown")
        if self.candidate_parent_limit > self.filter_parent_limit:
            raise ConfigError("candidate_parent_limit > filter_parent_limit")
        if self.candidate_parent_limit < 1:
            raise ConfigError("candidate_parent_limit < 1")
        if self.eval_batch_linger_ms < 0:
            raise ConfigError("eval_batch_linger_ms < 0")
        if self.eval_feature_cache_hosts < 1:
            raise ConfigError("eval_feature_cache_hosts < 1")


@dataclass
class GCSection:
    host_ttl_s: float = 6 * 3600.0
    task_ttl_s: float = 2 * 3600.0
    peer_ttl_s: float = 24 * 3600.0


@dataclass
class SchedulerConfig:
    scheduling: SchedulingSection = field(default_factory=SchedulingSection)
    gc: GCSection = field(default_factory=GCSection)


def build(
    cfg: Optional[SchedulerConfig] = None,
    *,
    device="cuda",
    scorer_blob: Optional[bytes] = None,
    rng: Optional[random.Random] = None,
) -> SchedulerService:
    """Composition root (scheduler.go:69-301 New), serving half.

    ``device`` is where a fused scorer serves (``"cuda"`` unless the
    caller asks for the CPU; no CUDA device raises).  ``scorer_blob`` is
    an exported scorer artifact (``trainer.export.scorer_to_bytes``) for
    the ``ml`` algorithm.  ``rng`` drives candidate sampling."""
    cfg = cfg or SchedulerConfig()
    cfg.scheduling.validate()
    device = resolve_device(device)
    sc = cfg.scheduling
    resource = Resource(
        host_ttl=cfg.gc.host_ttl_s,
        task_ttl=cfg.gc.task_ttl_s,
        peer_ttl=cfg.gc.peer_ttl_s,
    )
    # Every algorithm gets the columnar host store (DESIGN.md §18); only
    # ml additionally gets cross-request scorer micro-batching.
    feature_cache = HostFeatureCache(max_hosts=sc.eval_feature_cache_hosts)
    batcher = None
    if sc.algorithm == "ml":
        batcher = ScorerBatcher(linger_s=sc.eval_batch_linger_ms / 1e3)
    evaluator = new_evaluator(
        sc.algorithm, feature_cache=feature_cache, batcher=batcher
    )
    if scorer_blob is not None:
        if sc.algorithm != "ml":
            raise ConfigError("a scorer blob needs scheduling.algorithm 'ml'")
        evaluator.set_scorer(
            FusedMLPScorer.from_scorer(
                feature_cache, load_scorer(scorer_blob), device=device
            )
        )
    scheduling = Scheduling(
        evaluator,
        SchedulingConfig(
            candidate_parent_limit=sc.candidate_parent_limit,
            filter_parent_limit=sc.filter_parent_limit,
            retry_limit=sc.retry_limit,
            retry_back_to_source_limit=sc.retry_back_to_source_limit,
            retry_interval=sc.retry_interval_s,
        ),
        rng=rng,
    )
    return SchedulerService(resource, scheduling)
