"""Configuration: the trainer's and the scheduler's config files, YAML and
environment."""

from .schema import (  # noqa: F401
    ConfigError,
    GCSection,
    LifecycleSection,
    NetworkTopologySection,
    SchedulerConfigFile,
    SchedulingSection,
    StorageConfig,
    TrainerConfigFile,
    TrainingSection,
    load_config,
)
