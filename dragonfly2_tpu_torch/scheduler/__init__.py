"""Scheduler control plane (reference: scheduler/).

In-memory cluster state (hosts/tasks/peers with FSMs and a per-task peer
DAG), the columnar host store, the parent-selection engine with the rule,
network-topology and ML evaluators, the scorer micro-batcher the ML
evaluator uses, the model subscription that installs registry scorers on
it, the network-topology probe store, the training-record production path, and
the Announcer that uploads those records to the trainer.
"""

from .announcer import Announcer  # noqa: F401
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
from .networktopology import NetworkTopology, Probe, ProbeAgent, TopologyConfig  # noqa: F401
from .scheduling import ScheduleResult, ScheduleResultKind, Scheduling, SchedulingConfig  # noqa: F401
from .service import RegisterResult, SchedulerService  # noqa: F401
