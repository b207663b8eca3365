"""Device ops of the serving and training paths.

- ``fused_score`` — the fused slot-row gather + mask-folded MLP scoring
  kernel over the columnar host store's slot matrix, and the rule path's
  weighted-sum kernel (``csrc/fused_score.cu``).
- ``segment`` — the segment sum by destination (``csrc/segment_sum.cu``)
  and the neighbor gather whose backward it is (the GAT trainer).
- ``transpose_gather`` — the neighbor gather whose backward gathers over
  the transpose graph (plain PyTorch operations, no kernel).  Not
  exported: no model uses it, and on the card it lost to the index
  gather at GraphSAGE's shapes; import it from its module.
- ``aggregate`` — plain PyTorch aggregation ops, the numerics oracles.

The kernels are CUDA C++, built at first use by ``_build``; each has its
plain PyTorch version beside it, which a CPU tensor takes.
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
from .segment import make_neighbor_gather, segment_sum  # noqa: F401
