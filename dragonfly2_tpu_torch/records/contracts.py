"""The port's columnar dtype/shape contracts (DF012), declared once and
checked twice.

Entry for entry with the reference's ``records/contracts.py``, keyed by
the port's relpaths and its producers' names: the DFC1 record columns
(``records.features.DOWNLOAD_COLUMNS``), the ``HostFeatureCache`` slot
matrix (``[S, 12]`` float32), the scorer blob arrays, and the outputs of
K1 (``ops/fused_score.fused_gather_mlp_score``), K2 (``rule_sum``) and
K3 (``ops/segment.segment_sum_bucketed``), each beside its plain
version.

- **statically**, ``tools/dflint/tracerules.py`` reads ``CONTRACTS`` with
  ``ast.literal_eval`` when pointed at this file (its
  ``CONTRACTS_RELPATH`` names the reference's) and checks the listed
  producers for float64 leaks and the pinned creation-site dtypes;
- **dynamically**, ``tests/test_torch_lint.py`` asserts the live objects
  agree: ``DOWNLOAD_COLUMNS`` equals the declared list, and the kernels'
  plain versions return the dtypes ``outputs`` declares.

Entry shapes are the reference's, with two fields more: ``outputs``
(function -> the dtype of the tensor it returns) and ``shape``.

Because dflint evaluates ``CONTRACTS`` with ``ast.literal_eval``, the
dict MUST stay a pure literal: no names, calls, or comprehensions.
"""

from __future__ import annotations

CONTRACTS = {
    # -- DFC1 download rows (records/features.py + records/columnar.py) ----
    "dfc1.download": {
        "file": "dragonfly2_tpu_torch/records/features.py",
        "dtype": "float32",
        # STRICT: the reviewed float64 intermediates in
        # edge_features_batch carry inline `# dflint: disable=DF012`
        # pragmas instead of a blanket allow, so widening any OTHER
        # construction to float64 still fails by contract name.
        "functions": [
            "download_to_rows",
            "host_features",
            "edge_features",
            "edge_features_batch",
            "mask_post_hoc",
        ],
        "columns": [
            "src_bucket", "dst_bucket",
            "child_cpu_percent", "child_mem_used_percent",
            "child_disk_used_percent", "child_tcp_conn_log",
            "child_upload_tcp_conn_log", "child_upload_load",
            "child_upload_success_ratio", "child_upload_count_log",
            "child_type_normal", "child_type_super", "child_type_strong",
            "child_type_weak",
            "parent_cpu_percent", "parent_mem_used_percent",
            "parent_disk_used_percent", "parent_tcp_conn_log",
            "parent_upload_tcp_conn_log", "parent_upload_load",
            "parent_upload_success_ratio", "parent_upload_count_log",
            "parent_type_normal", "parent_type_super", "parent_type_strong",
            "parent_type_weak",
            "same_idc", "location_affinity", "piece_count_log",
            "mean_piece_size_log", "content_length_log",
            "finished_piece_ratio", "parent_cost_log_s",
            "parent_upload_pieces_log",
            "target_log_bw",
        ],
    },
    "dfc1.topology": {
        "file": "dragonfly2_tpu_torch/records/features.py",
        "dtype": "float32",
        "functions": ["topology_to_rows"],
        "columns": [
            "src_bucket", "dst_bucket", "avg_rtt_norm", "src_tcp_conn_log",
            "dst_tcp_conn_log", "same_idc", "location_affinity", "freshness",
        ],
    },
    "dfc1.file": {
        "file": "dragonfly2_tpu_torch/records/columnar.py",
        "dtype": "float32",
        "defaults": {
            "ColumnarHeader.dtype": "float32",
            "ColumnarWriter.__init__.dtype": "float32",
        },
    },
    # -- Columnar host store (scheduler/featcache.py, DESIGN.md §18) -------
    # The slot matrix is the SOURCE OF TRUTH for host serving state:
    # every column is creation-site pinned, so widening any of them (or
    # adding an unpinned float64 construction to a producer) fails lint
    # by contract name.  float64 is DELIBERATE for the timestamp and the
    # pre-scaled rule-score columns: they must reproduce the scalar
    # oracle's python-double math bit-for-bit (host code, never traced).
    "featcache.slots": {
        "file": "dragonfly2_tpu_torch/scheduler/featcache.py",
        "dtype": "float32",
        # The slot matrix K1 gathers from: [S, 12] rows, one a host slot.
        "shape": ["S", 12],
        "allow": ["float64"],
        "attrs": {
            "HostFeatureCache._matrix": "float32",
            "HostFeatureCache._bucket_col": "int64",
            "HostFeatureCache._idc_col": "int64",
            "HostFeatureCache._idc_ci_col": "int64",
            "HostFeatureCache._loc_col": "int64",
            "HostFeatureCache._upload_count_col": "int64",
            "HostFeatureCache._upload_failed_col": "int64",
            "HostFeatureCache._concurrent_upload_col": "int64",
            "HostFeatureCache._upload_limit_col": "int64",
            "HostFeatureCache._peer_count_col": "int64",
            "HostFeatureCache._updated_at_col": "float64",
            "HostFeatureCache._rule_w_cols": "float64",
            "HostFeatureCache._pair_col": "int64",
            "HostFeatureCache._type_normal_col": "int8",
            "HostFeatureCache._stamp_col": "int64",
        },
        "functions": [
            "HostFeatureCache.serve",
            "HostFeatureCache.rule_serve",
            "HostFeatureCache.rule_scores",
            "HostFeatureCache.gather_with_buckets",
            "HostFeatureCache._fill_slot_locked",
            "HostFeatureCache._derive_upload_cells",
            "HostFeatureCache.write_upload_state",
            "HostFeatureCache._serve_uncached",
            "HostFeatureCache._rule_serve_uncached",
            "HostFeatureCache._aff_row_locked",
            "HostFeatureCache._pair_row_locked",
        ],
    },
    # -- scorer blob arrays (trainer/export.py) ----------------------------
    "scorer.mlp": {
        "file": "dragonfly2_tpu_torch/trainer/export.py",
        "dtype": "float32",
        # STRICT: feature_snapshot_stats' float64 binning carries inline
        # pragmas (rounds once on return) — see dfc1.download.
        "functions": [
            "_flatten_mlp_params",
            "export_mlp_scorer",
            "export_from_state",
            "feature_snapshot_stats",
            "_pack",
            "load_scorer",
            "MLPScorer.score",
            "MLPScorer._serving_weights",
        ],
    },
    # int8/bf16 post-training-quantized serving variant: the blob packs
    # quantized payloads + per-channel scales next to the drift
    # histograms; scoring runs the float32 DEQUANTIZED weights, so every
    # producer below must stay float32-out (int8/uint16 payloads are the
    # storage form, not a compute dtype).
    "scorer.quantized": {
        "file": "dragonfly2_tpu_torch/trainer/export.py",
        "dtype": "float32",
        "functions": [
            "quantize_scorer",
            "_int8_quantize",
            "_bf16_round",
            "_dequantize_layers",
        ],
    },
    "scorer.gnn": {
        "file": "dragonfly2_tpu_torch/trainer/export.py",
        "dtype": "float32",
        "functions": [
            "export_gnn_scorer",
            "gnn_scorer_to_bytes",
            "GNNScorer.score",
            "GNNScorer._lookup",
            "GNNScorer.__post_init__",
        ],
    },
    # -- the kernels (ops/): K3, K1 and K2 -----------------------------------
    # ``outputs``: each kernel wrapper (and its plain version) -> the dtype
    # of the tensor it returns (runtime-asserted against the plain
    # versions on the CPU).
    "ops.segment_sum": {
        "file": "dragonfly2_tpu_torch/ops/segment.py",
        "dtype": "float32",
        # exact=False runs native bf16 MXU passes with f32 accumulate.
        "allow": ["bfloat16"],
        "functions": [
            "bucket_edges_by_block",
            "kernel_chunks",
            "_segment_sum_plain",
            "segment_sum_bucketed",
            "segment_sum",
            "make_neighbor_gather",
        ],
        "outputs": {
            "segment_sum_bucketed": "float32",
            "_segment_sum_plain": "float32",
        },
    },
    "ops.transpose_gather": {
        "file": "dragonfly2_tpu_torch/ops/transpose_gather.py",
        "dtype": "float32",
        "functions": ["build_transpose_table", "make_transpose_gather"],
    },
    # K1: the fused slot-row gather + mask-folded MLP score over the
    # columnar host store's slot matrix (DESIGN.md §18), and K2, the rule
    # components' weighted sum: float32 end to end (slot ids int32 are
    # the storage/index form).
    "ops.fused_score": {
        "file": "dragonfly2_tpu_torch/ops/fused_score.py",
        "dtype": "float32",
        "functions": [
            "fold_post_hoc_weights",
            "split_first_layer",
            "pack_k1_weights",
            "_fused_score_plain",
            "fused_gather_mlp_score",
            "FusedMLPScorer.score",
            "FusedMLPScorer.score_rows",
            "FusedMLPScorer._sync_mirror",
            "_rule_sum_plain",
            "rule_sum",
            "rule_weighted_sum",
        ],
        "outputs": {
            "fused_gather_mlp_score": "float32",
            "_fused_score_plain": "float32",
            "rule_sum": "float32",
            "_rule_sum_plain": "float32",
        },
    },
}
