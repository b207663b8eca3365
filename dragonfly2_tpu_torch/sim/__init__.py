"""In-process swarm fixtures for the scheduler stack."""

from .swarm import build_announce_swarm, host_from_latent  # noqa: F401
