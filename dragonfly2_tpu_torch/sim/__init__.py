"""In-process swarm simulation: the real scheduler service, probe store
and record storage driven against the SyntheticCluster's ground-truth
bandwidth and RTT model, and the lifecycle drill."""

from .swarm import (  # noqa: F401
    SwarmConfig,
    SwarmSimulator,
    build_announce_swarm,
    host_from_latent,
)
from .lifecycle import LifecycleDrillConfig, run_lifecycle_drill  # noqa: F401
