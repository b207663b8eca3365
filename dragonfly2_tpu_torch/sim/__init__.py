"""In-process swarm simulation: the real scheduler service, probe store
and record storage driven against the SyntheticCluster's ground-truth
bandwidth and RTT model, the lifecycle drill, the columnar fleet of
scheduler shards, and the chaos drills' process plumbing."""

from .swarm import (  # noqa: F401
    SwarmConfig,
    SwarmSimulator,
    build_announce_swarm,
    host_from_latent,
)
from .lifecycle import LifecycleDrillConfig, run_lifecycle_drill  # noqa: F401
from .fleet import (  # noqa: F401
    ColumnarPopulation,
    FleetConfig,
    FleetSwarmDriver,
    ShardedFleet,
)
from .chaos import (  # noqa: F401
    ChaosProcess,
    ChaosScenario,
    crash_at,
    drop_storm,
    replay_history,
    sha256_hex,
    task_digest,
    wait_until,
)
