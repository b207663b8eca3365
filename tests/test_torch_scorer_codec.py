"""Port parity: the scorer artifact crosses between the JAX package's
``trainer/export.py`` and the port's, both ways.

A blob written by either package loads in the other and scores
bit-equal on the numpy path, for float, int8 and bf16 artifacts (the
``test_ops`` quantized-blob contract) and for GNN artifacts.  ``export_mlp_scorer`` turns
flax ``MLPRegressor`` params, converted to numpy, into the same weights
in both packages, and the port serves them as the flax model computes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dragonfly2_tpu.models.mlp import MLPConfig, MLPRegressor
from dragonfly2_tpu.trainer import export as jax_export
from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
from dragonfly2_tpu_torch.scheduler import HostFeatureCache
from dragonfly2_tpu_torch.trainer import export


def _weights(seed=4, dims=(32, 64, 64, 1)):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05,
        )
        for i in range(len(dims) - 1)
    ]


def _artifact(pkg, mode):
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((400, 32)).astype(np.float32)
    edges, fracs = pkg.feature_snapshot_stats(rows)
    base = pkg.MLPScorer(
        weights=_weights(), train_bin_edges=edges, train_bin_fracs=fracs
    )
    return rows, base if mode == "float" else pkg.quantize_scorer(base, mode)


@pytest.mark.parametrize("mode", ["float", "int8", "bf16"])
@pytest.mark.parametrize(
    "writer,reader", [(jax_export, export), (export, jax_export)],
    ids=["jax_to_torch", "torch_to_jax"],
)
def test_blob_loads_across_packages_and_scores_bit_equal(mode, writer, reader):
    rows, written = _artifact(writer, mode)
    blob = writer.scorer_to_bytes(written)
    loaded = reader.load_scorer(blob)
    same_pkg = writer.load_scorer(blob)
    assert type(loaded).__name__ == type(written).__name__
    assert loaded.model_type == written.model_type
    assert loaded.post_hoc_masked == written.post_hoc_masked
    assert loaded.feature_names == written.feature_names
    for (w, b), (w2, b2) in zip(loaded.weights, written.weights):
        assert np.array_equal(w, w2) and np.array_equal(b, b2)
    assert np.array_equal(loaded.train_bin_edges, written.train_bin_edges)
    assert np.array_equal(loaded.train_bin_fracs, written.train_bin_fracs)
    if mode != "float":
        assert loaded.quant_mode == mode
        for (q, s), (q2, s2) in zip(loaded.qlayers, written.qlayers):
            assert q.dtype == q2.dtype and np.array_equal(q, q2)
            assert (s is None) == (s2 is None)
            assert s is None or np.array_equal(s, s2)
    assert np.array_equal(loaded.score(rows), same_pkg.score(rows))
    assert np.array_equal(loaded.score(rows), written.score(rows))
    # Re-packing in the reading package gives the same blob layout back.
    again = writer.load_scorer(reader.scorer_to_bytes(loaded))
    assert np.array_equal(again.score(rows), written.score(rows))


@pytest.mark.parametrize(
    "writer,reader", [(jax_export, export), (export, jax_export)],
    ids=["jax_to_torch", "torch_to_jax"],
)
def test_gnn_blob_round_trips_across_packages(writer, reader):
    rng = np.random.default_rng(5)
    scorer = writer.GNNScorer(
        buckets=np.arange(4, dtype=np.int64) * 3,
        embeddings=rng.standard_normal((4, 2)).astype(np.float32),
        head_weights=[(rng.standard_normal((6, 1)).astype(np.float32),
                       np.full(1, 0.5, np.float32))],
    )
    loaded = reader.load_scorer(writer.gnn_scorer_to_bytes(scorer))
    assert type(loaded).__name__ == "GNNScorer" and loaded.model_type == "gnn"
    src, dst = np.array([0, 3, 9, 7]), np.array([6, 6, 0, 3])
    assert np.array_equal(
        loaded.score(None, src_buckets=src, dst_buckets=dst),
        scorer.score(None, src_buckets=src, dst_buckets=dst),
    )
    again = writer.load_scorer(reader.gnn_scorer_to_bytes(loaded))
    assert np.array_equal(again.embeddings, scorer.embeddings)


def _flax_params(hidden=(64, 64), seed=0):
    model = MLPRegressor(MLPConfig(hidden=hidden, dropout=0.0, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32), jnp.float32))
    return model, params["params"]


def test_export_mlp_scorer_from_flax_params_matches_jax_export():
    model, params = _flax_params()
    as_numpy = jax.tree_util.tree_map(np.asarray, params)
    ours = export.export_mlp_scorer(as_numpy, post_hoc_masked=False)
    theirs = jax_export.export_mlp_scorer(params, post_hoc_masked=False)
    assert [w.shape for w, _ in ours.weights] == [(32, 64), (64, 64), (64, 1)]
    for (w, b), (w2, b2) in zip(ours.weights, theirs.weights):
        assert np.array_equal(w, w2) and np.array_equal(b, b2)
    rows = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
    assert np.array_equal(ours.score(rows), theirs.score(rows))
    # The exported [in, out] layout serves as the flax model computes
    # (nn.gelu is the tanh form, as the scorer's).
    want = np.asarray(model.apply({"params": params}, jnp.asarray(rows)))
    np.testing.assert_allclose(ours.score(rows), want, rtol=1e-4, atol=1e-4)


def test_flax_exported_blob_serves_through_the_fused_scorer():
    """The exported artifact, through the port's blob codec, into the
    fused scorer's plain K1 path on slot-gathered rows."""
    import torch

    model, params = _flax_params(seed=3)
    scorer = export.load_scorer(
        export.scorer_to_bytes(
            export.export_mlp_scorer(
                jax.tree_util.tree_map(np.asarray, params), post_hoc_masked=False
            )
        )
    )
    fused = FusedMLPScorer.from_scorer(HostFeatureCache(max_hosts=8), scorer, device="cpu")
    rng = np.random.default_rng(2)
    mat = rng.standard_normal((16, 12)).astype(np.float32)
    slots = rng.integers(0, 16, 10).astype(np.int32)
    dslots = rng.integers(0, 16, 10).astype(np.int32)
    edge = rng.standard_normal((10, 8)).astype(np.float32)
    got = fused.mlp(*(torch.from_numpy(a) for a in (mat, slots, dslots, edge))).numpy()
    rows = np.concatenate([mat[dslots], mat[slots], edge], axis=1)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(rows)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
