"""Scheduler control plane (reference: scheduler/), serving half.

In-memory cluster state (hosts/tasks/peers with FSMs and a per-task peer
DAG), the columnar host store, the parent-selection engine with the rule
and ML evaluators, the scorer micro-batcher the ML evaluator uses, and
the model subscription that installs registry scorers on it.
"""

from .resource import (  # noqa: F401
    Host,
    HostManager,
    Peer,
    PeerManager,
    Resource,
    Task,
    TaskManager,
)
from .evaluator import CanaryRoute, Evaluator, MLEvaluator, new_evaluator  # noqa: F401
from .featcache import HostFeatureCache  # noqa: F401
from .microbatch import ScorerBatcher, ScorerUnavailable  # noqa: F401
from .model_loader import ModelSubscriber  # noqa: F401
from .scheduling import ScheduleResult, ScheduleResultKind, Scheduling, SchedulingConfig  # noqa: F401
from .service import RegisterResult, SchedulerService  # noqa: F401
