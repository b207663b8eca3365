"""Configuration: the trainer's config file, YAML and environment."""

from .schema import (  # noqa: F401
    ConfigError,
    LifecycleSection,
    TrainerConfigFile,
    TrainingSection,
    load_config,
)
