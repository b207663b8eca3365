"""Trainer metrics (reference: trainer/metrics/metrics.go:33-50 —
training_total / training_failure_total, extended with the training
loop's observables).

Port of the batch trainer's four series of
``dragonfly2_tpu/trainer/metrics.py``, on the port's ``utils/metrics``
registry; the online graph trainer's series come with that trainer.
"""

from __future__ import annotations

from ..utils.metrics import default_registry as _reg

TRAINING_TOTAL = _reg.counter(
    "trainer_training_total", "Training runs", ["model", "result"]
)
TRAINING_RECORDS = _reg.counter(
    "trainer_training_records_total", "Records consumed by training", ["model"]
)
TRAINING_DURATION = _reg.histogram(
    "trainer_training_duration_seconds", "Wall time per training run",
    buckets=(1, 5, 15, 60, 300, 900, 3600),
)
MODELS_PUBLISHED = _reg.counter(
    "trainer_models_published_total", "Models pushed to the registry", ["model"]
)
