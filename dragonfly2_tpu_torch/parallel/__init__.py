"""Distributed execution over a (data, model) mesh of devices.

Port of ``dragonfly2_tpu/parallel``.  The reference's trainer runs JAX
collectives over ICI/DCN from one controller; here one process drives
each device and the collectives are ``torch.distributed`` ones (NCCL on
the card, gloo on the CPU), written out in ``mesh`` (the grid and the
collective wrappers) and ``graph_sharding`` (halo exchange, node-sharded
precompute and tables).  ``dryrun`` spawns ranks and runs the multi-device
dry run.

Exports what the reference's package exports, but ``batch_sharding`` and
``replicated``, which have no counterpart: a rank holds its rows of a
batch and a whole copy of every replicated tensor.
"""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    create_mesh,
    host_local_batch,
)
