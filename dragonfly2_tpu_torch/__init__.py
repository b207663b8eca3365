"""dragonfly2_tpu_torch — the PyTorch/CUDA port of ``dragonfly2_tpu``.

A second package beside the JAX one, with the same layout and names so
each module's counterpart is easy to find.  It imports ``torch``,
``numpy`` and the standard library only; the JAX package stays in the
repository as the reference the port is tested against.

Ported so far: the scheduler's ML parent-ranking (serving) path, the
graph rankers' training, the learned-scheduling loop and the trainer
service —

- ``utils``     — types, hostinfo, FSM, DAG, digest, idgen, metrics,
                  logging, the debug endpoint, SLO declarations, typed
                  errors, fault injection, the GC runner.
- ``records``   — record schemas, featurization, DFC1 columnar files, the
                  reference-CSV codec, the synthetic cluster.
- ``scheduler`` — resources, columnar host store, evaluators, scorer
                  micro-batcher, scheduling engine, service, model
                  subscription, the Announcer, topology sync.
- ``models``    — the GAT and hop rankers, the MLP regressor.
- ``trainer``   — batch MLP and graph training, the streaming trainer,
                  the scorer artifacts, the trainer service.
- ``manager``, ``rollout``, ``lifecycle`` — the model registry, scheduler
                  membership and the REST surface, the rollout plane,
                  the lifecycle daemon.
- ``rpc``       — the HTTP transports: scheduler, trainer, registry and
                  cluster clients and servers, retries, the hash ring.
- ``ops``       — the fused slot-row gather + MLP scoring kernel, the
                  rule weighted-sum kernel and the segment sum, CUDA C++
                  under ``csrc/``.
- ``sim``       — announce-swarm fixtures, the lifecycle drill.
- ``config``    — the trainer's and the scheduler's config files.
- ``cli``       — the scheduler and trainer binaries: serve mode
                  (``serve``), ``--simulate`` and ``--train-once``.
- ``bench``     — timing helpers and the card's measurement scripts.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
