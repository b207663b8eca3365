"""Self-driving model lifecycle plane (DESIGN.md §29): continuous
train → export → rollout with zero human steps."""

from .arbiter import (
    GLOBAL_KEY,
    arbitrate_candidates,
    plan_epoch,
    regional_model_name,
)
from .daemon import LifecycleConfig, LifecycleDaemon, file_replay_source
from .state import LifecycleStore

__all__ = [
    "GLOBAL_KEY",
    "LifecycleConfig",
    "LifecycleDaemon",
    "LifecycleStore",
    "arbitrate_candidates",
    "file_replay_source",
    "plan_epoch",
    "regional_model_name",
]
