"""Device ops of the serving path.

- ``fused_score`` — the fused slot-row gather + mask-folded MLP scoring
  kernel over the columnar host store's slot matrix, and the rule path's
  weighted-sum kernel.  Both are CUDA C++ (``csrc/fused_score.cu``),
  built at first use by ``_build``; each has its plain PyTorch version
  beside it, which a CPU tensor takes.
"""

from .fused_score import (  # noqa: F401
    RULE_COMPONENT_WEIGHTS,
    FusedMLPScorer,
    ServingMLP,
    fold_post_hoc_weights,
    fused_gather_mlp_score,
    rule_sum,
    rule_weighted_sum,
    split_first_layer,
)
