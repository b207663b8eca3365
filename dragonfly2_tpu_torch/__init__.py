"""dragonfly2_tpu_torch — the PyTorch/CUDA port of ``dragonfly2_tpu``.

A second package beside the JAX one, with the same layout and names so
each module's counterpart is easy to find.  It imports ``torch``,
``numpy`` and the standard library only; the JAX package stays in the
repository as the reference the port is tested against.

Ported so far: the scheduler's ML parent-ranking (serving) path —

- ``utils``     — types, hostinfo, FSM, DAG, digest, idgen, metrics.
- ``records``   — record schemas, featurization, synthetic host latents.
- ``scheduler`` — resources, columnar host store, evaluators, scorer
                  micro-batcher, scheduling engine, service.
- ``trainer``   — the MLP scorer artifact (``export``).
- ``ops``       — the fused slot-row gather + MLP scoring kernel and the
                  rule weighted-sum kernel, CUDA C++ under ``csrc/``.
- ``sim``       — announce-swarm fixtures.
- ``cli``       — the scheduler composition root (``build``).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
