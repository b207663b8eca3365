"""Configuration: the trainer's, the scheduler's, the manager's and the
peer daemon's config files, YAML and environment."""

from .schema import (  # noqa: F401
    ConfigError,
    DaemonConfig,
    DaemonStorageSection,
    GCSection,
    LifecycleSection,
    ManagerConfig,
    ModelRegistrySection,
    NetworkTopologySection,
    ProxySection,
    RolloutSection,
    SchedulerConfigFile,
    SchedulingSection,
    StorageConfig,
    TrainerConfigFile,
    TrainingSection,
    load_config,
)
