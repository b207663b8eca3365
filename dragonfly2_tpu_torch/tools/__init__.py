"""Operational tools (reference: test/tools/ — stress load generator,
fixture servers).

Port of ``dragonfly2_tpu/tools``."""
