"""Port parity: ``dragonfly2_tpu_torch/ops/fused_score.py`` against the JAX
package's ``ops/pallas_score.py`` — its Pallas kernel in interpret mode
and its jnp path — and against the numpy ``MLPScorer``, on the same
seeded inputs.

These run on the CPU, where the port's kernel wrappers take their plain
PyTorch versions (a CPU tensor never reaches a CUDA kernel).  JAX-side
shapes stay inside the compile budget of ``tools/dflint/compile_budget
.toml``: rule rows <= 128, interpret-mode scorers at ``cand_block=8`` and
<= 24 rows, one fresh JAX scorer per shape set.

Tolerances: the port's plain K1 against the JAX kernel / jnp path 2e-5
(f32, three partial products summed in another order); against the
numpy scorer 1e-4 (numpy's f32 reduction order); the rule sum 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import pallas_score as jax_ops
from dragonfly2_tpu.scheduler import HostFeatureCache as JaxCache
from dragonfly2_tpu.scheduler import MLEvaluator as JaxMLEvaluator
from dragonfly2_tpu.sim.swarm import build_announce_swarm as jax_swarm
from dragonfly2_tpu.trainer.export import MLPScorer as JaxMLPScorer
from dragonfly2_tpu_torch.ops import fused_score as ops
from dragonfly2_tpu_torch.records.features import POST_HOC_FEATURE_IDX
from dragonfly2_tpu_torch.scheduler import HostFeatureCache, MLEvaluator
from dragonfly2_tpu_torch.sim.swarm import build_announce_swarm
from dragonfly2_tpu_torch.trainer.export import MLPScorer


def _weights(seed=0, dims=(32, 64, 64, 1)):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05,
        )
        for i in range(len(dims) - 1)
    ]


def _serving(n_hosts, seed=3, max_hosts=512):
    """Both packages' announce swarm from one seed, each with a store
    that bound every host in the same order (so slot ids agree) and a
    numpy-scorer evaluator."""
    weights = _weights(seed)
    jtask, jpeers = jax_swarm(n_hosts, seed=seed)
    jcache = JaxCache(max_hosts=max_hosts)
    jcache.gather([p.host for p in jpeers])
    jml = JaxMLEvaluator(JaxMLPScorer(weights=weights), feature_cache=jcache)
    task, peers = build_announce_swarm(n_hosts, seed=seed)
    cache = HostFeatureCache(max_hosts=max_hosts)
    cache.gather([p.host for p in peers])
    ml = MLEvaluator(MLPScorer(weights=weights), feature_cache=cache)
    return weights, (jpeers, jcache, jml), (peers, cache, ml)


def _as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_plain_k1_matches_jax_kernel_interpret_and_jnp_path():
    weights, (jpeers, jcache, jml), (peers, cache, ml) = _serving(60)
    edge, slots, cslot, _, _ = jml._featurize_slots(jpeers[1:25], jpeers[0])
    dst = np.full(len(slots), cslot, dtype=np.int64)
    jnp_path = jax_ops.FusedMLPScorer(jcache, weights, use_pallas=False)
    kernel = jax_ops.FusedMLPScorer(
        jcache, weights, use_pallas=True, interpret=True, cand_block=8
    )
    want_jnp = jnp_path.score(edge, src_buckets=slots, dst_buckets=dst)
    want_kernel = kernel.score(edge, src_buckets=slots, dst_buckets=dst)

    # The port's K1 wrapper on exactly the JAX side's inputs.
    _, snap = jcache.matrix_snapshot()
    mat, s, d, e = _as_torch(
        snap, slots.astype(np.int32), dst.astype(np.int32), edge
    )
    mlp = ops.ServingMLP(weights, device="cpu")
    got = ops.fused_gather_mlp_score(mat, s, d, e, mlp).numpy()
    assert got.dtype == np.float32 and got.shape == (24,)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_jnp, rtol=2e-5, atol=2e-5)

    # The port's scorer over its own store gives the same rows and slots.
    pedge, pslots, pcslot, _, _ = ml._featurize_slots(peers[1:25], peers[0])
    assert np.array_equal(pedge, edge) and np.array_equal(pslots, slots)
    assert pcslot == cslot
    rows = np.append(slots, cslot)
    assert np.array_equal(cache.matrix_snapshot()[1][rows], snap[rows])
    fused = ops.FusedMLPScorer(cache, weights, cand_block=8, device="cpu")
    scored = fused.score(pedge, src_buckets=pslots, dst_buckets=dst)
    np.testing.assert_allclose(scored, got, rtol=1e-6, atol=1e-6)

    # Both against the numpy serving scorer (sum order differs).
    feats, _, _ = ml._featurize_batch(peers[1:25], peers[0])
    want = MLPScorer(weights=weights).score(feats)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(want_kernel, want, rtol=1e-4, atol=1e-4)


def test_non_kernel_depth_takes_split_matmul_path_like_jax():
    """A 4-layer artifact serves through the split-matmul torch path, as
    the JAX package sends it to its jnp path."""
    dims = (32, 64, 64, 32, 1)
    weights, (jpeers, jcache, jml), (peers, cache, ml) = _serving(40)
    weights = _weights(7, dims)
    edge, slots, cslot, _, _ = ml._featurize_slots(peers[1:20], peers[0])
    dst = np.full(len(slots), cslot, dtype=np.int64)
    fused = ops.FusedMLPScorer(cache, weights, device="cpu")
    assert fused.mlp.depth == 4
    got = fused.score(edge, src_buckets=slots, dst_buckets=dst)
    want_jax = jax_ops.FusedMLPScorer(jcache, weights, use_pallas=False).score(
        edge, src_buckets=slots, dst_buckets=dst
    )
    np.testing.assert_allclose(got, want_jax, rtol=2e-5, atol=2e-5)
    feats, _, _ = ml._featurize_batch(peers[1:20], peers[0])
    np.testing.assert_allclose(
        got, MLPScorer(weights=weights).score(feats), rtol=1e-4, atol=1e-4
    )
    with pytest.raises(ValueError):
        ops.fused_gather_mlp_score(
            *_as_torch(cache.matrix_snapshot()[1], slots.astype(np.int32),
                       dst.astype(np.int32), edge),
            fused.mlp,
        )


def test_padding_rows_do_not_bleed():
    weights, _, (peers, cache, ml) = _serving(40)
    fused = ops.FusedMLPScorer(cache, weights, cand_block=16, device="cpu")
    edge, slots, cslot, _, _ = ml._featurize_slots(peers[1:8], peers[0])
    dst = np.full(len(slots), cslot, dtype=np.int64)
    a = fused.score(edge, src_buckets=slots, dst_buckets=dst)   # n=7 → pad 16
    assert a.shape == (7,)
    # Same rows inside a differently-padded call score identically.
    edge2, slots2, cslot2, _, _ = ml._featurize_slots(peers[1:20], peers[0])
    dst2 = np.full(len(slots2), cslot2, dtype=np.int64)
    b = fused.score(edge2, src_buckets=slots2, dst_buckets=dst2)[:7]
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_mirror_resyncs_on_column_writes():
    weights, _, (peers, cache, ml) = _serving(30)
    fused = ops.FusedMLPScorer(cache, weights, device="cpu")
    edge, slots, cslot, _, _ = ml._featurize_slots(peers[1:9], peers[0])
    dst = np.full(len(slots), cslot, dtype=np.int64)
    before = fused.score(edge, src_buckets=slots, dst_buckets=dst)
    ver = fused._mat_version
    # Announce-path write-through moves the store's row version; the
    # next flush re-uploads the mirror and the scores move.
    for p in peers[1:9]:
        p.host.upload_count += 50
    after = fused.score(edge, src_buckets=slots, dst_buckets=dst)
    assert fused._mat_version != ver
    assert not np.array_equal(before, after)


def test_from_scorer_rejects_standardized_artifacts():
    s = MLPScorer(
        weights=_weights(1),
        feat_mean=np.zeros(32, np.float32),
        feat_std=np.ones(32, np.float32),
    )
    with pytest.raises(ValueError):
        ops.FusedMLPScorer.from_scorer(HostFeatureCache(max_hosts=8), s, device="cpu")


def test_mask_folding_matches_jax_and_zeroes_post_hoc_columns():
    weights = _weights(5)
    folded = ops.fold_post_hoc_weights(weights)
    jax_folded = jax_ops.fold_post_hoc_weights(weights)
    for (w, b), (jw, jb) in zip(folded, jax_folded):
        assert np.array_equal(w, jw) and np.array_equal(b, jb)
    for i in POST_HOC_FEATURE_IDX:
        assert np.all(folded[0][0][i] == 0.0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    x2 = np.array(x, copy=True)
    x2[:, list(POST_HOC_FEATURE_IDX)] = rng.standard_normal(
        (16, len(POST_HOC_FEATURE_IDX))
    ).astype(np.float32)
    s = MLPScorer(weights=folded, post_hoc_masked=False)
    assert np.array_equal(s.score(x), s.score(x2))
    # The served module folds the same rows: post-hoc edge columns
    # cannot move the plain K1's scores either.
    mlp = ops.ServingMLP(weights, device="cpu")
    mat = torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32))
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    e1 = torch.from_numpy(np.ascontiguousarray(x[:4, 24:]))
    e2 = torch.from_numpy(np.ascontiguousarray(x2[:4, 24:]))
    assert torch.equal(
        ops.fused_gather_mlp_score(mat, idx, idx.flip(0).contiguous(), e1, mlp),
        ops.fused_gather_mlp_score(mat, idx, idx.flip(0).contiguous(), e2, mlp),
    )


@pytest.mark.parametrize("dims", [(32, 64, 64, 1), (32, 96, 48, 1), (32, 50, 30, 1),
                                  (32, 40, 160, 1)], ids=["64x64", "96x48", "50x30", "40x160"])
def test_k1_weight_blob_unpacks_to_the_serving_buffers(dims):
    mlp = ops.ServingMLP(_weights(6, dims), device="cpu")
    d1, d2 = dims[1], dims[2]
    blob = mlp.k1_blob.numpy()
    a, b, d1p, d2p = ops.k1_blob_layout(d1, d2)
    assert blob.dtype == np.float32 and blob.shape == (a + b,)
    assert a % 4 == 0 and b % 4 == 0 and d2p % 4 == 0      # every part on 16 bytes
    assert d1p % 4 == 0 and d1 <= d1p < d1 + 4 and d2 <= d2p < d2 + 4
    # The served weights, made apart from the blob: mask-folded, W0 split.
    served = ops.fold_post_hoc_weights(_weights(6, dims))
    w0c, w0p, w0e = ops.split_first_layer(served[0][0])
    (w1, b1), (w2, b2) = served[1:]
    want = {"w0c": w0c, "w0p": w0p, "w0e": w0e, "b0": served[0][1], "w1": w1, "b1": b1,
            "w2": w2, "b2": b2}
    got = ops.unpack_k1_weights(blob, d1, d2)
    (mw1, mb1), (mw2, mb2) = mlp.layers()
    buffers = {"w0c": mlp.w0c, "w0p": mlp.w0p, "w0e": mlp.w0e, "b0": mlp.b0,
               "w1": mw1, "b1": mb1, "w2": mw2, "b2": mb2}
    assert set(got) == set(want) == set(buffers)
    for name, arr in want.items():
        arr = np.asarray(arr, np.float32).reshape(buffers[name].shape)
        assert got[name].shape == arr.shape, name
        assert np.array_equal(got[name].view(np.uint32), arr.view(np.uint32)), name
        assert np.array_equal(buffers[name].numpy().view(np.uint32), arr.view(np.uint32)), name
        # One store: the module's per-layer buffers are views of the blob.
        assert (buffers[name].untyped_storage().data_ptr()
                == mlp.k1_blob.untyped_storage().data_ptr()), name
    # Everything else in the blob is padding, and zero.
    mask = np.ones(a + b, bool)
    mask[: 33 * d1] = False
    w1_used = np.zeros((d1p, d2p), bool)
    w1_used[:d1, :d2] = True
    mask[a : a + d1p * d2p] = ~w1_used.reshape(-1)
    o = a + d1p * d2p
    mask[o : o + d2] = mask[o + d2p : o + d2p + d2] = False
    mask[o + 2 * d2p] = False
    assert not blob[mask].any()


def test_k1_stamp_points_lie_on_the_kernel_source():
    """The K1 profiling copy (bench/k1_stamps.py) finds each of its stamp
    points once in the package's kernel source."""
    from dragonfly2_tpu_torch.bench import k1_stamps
    from dragonfly2_tpu_torch.ops import _build

    source = (_build.SOURCE_DIR / "fused_score.cu").read_text()
    assert "K1_STAMP" not in source and "clock64" not in source
    stamped = k1_stamps.instrument(source)
    for i in range(len(k1_stamps.STAMP_POINTS)):
        assert stamped.count(f"K1_STAMP({i});") == 1
    assert "df_k1_stamps_read" in stamped
    with pytest.raises(ValueError):
        k1_stamps.instrument(source.replace("  mbar_wait0(&bars[1]);\n", ""))


def test_fused_scorer_staging_across_flush_sizes_matches_jax():
    """One scorer over flushes of three padded sizes (its staging buffer
    grows and is reused) against the JAX package's fused scorer."""
    weights, (jpeers, jcache, jml), (peers, cache, ml) = _serving(60)
    jfused = jax_ops.FusedMLPScorer(jcache, weights, use_pallas=False, cand_block=8)
    fused = ops.FusedMLPScorer(cache, weights, cand_block=8, device="cpu")
    for n in (3, 20, 9):
        edge, slots, cslot, _, _ = ml._featurize_slots(peers[1 : n + 1], peers[0])
        jedge, jslots, jcslot, _, _ = jml._featurize_slots(jpeers[1 : n + 1], jpeers[0])
        dst = np.full(n, cslot, dtype=np.int64)
        got = fused.score(edge, src_buckets=slots, dst_buckets=dst)
        want = jfused.score(jedge, src_buckets=jslots, dst_buckets=np.full(n, jcslot))
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert fused.uploads == fused.downloads == 0      # the CPU makes no copies


def test_split_first_layer_matches_jax():
    w0 = _weights(2)[0][0]
    for a, b in zip(ops.split_first_layer(w0), jax_ops.split_first_layer(w0)):
        assert a.flags["C_CONTIGUOUS"] and np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 37, 128])
def test_rule_weighted_sum_matches_jax_and_numpy(n):
    rng = np.random.default_rng(9 + n)
    comp = rng.standard_normal((n, 6)).astype(np.float32)
    want = comp @ np.asarray(ops.RULE_COMPONENT_WEIGHTS, np.float32)
    got = ops.rule_weighted_sum(comp, device="cpu")
    got_jax_kernel = jax_ops.rule_weighted_sum(comp, interpret=True)
    got_jax_jnp = jax_ops.rule_weighted_sum(comp, use_pallas=False)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, got_jax_kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, got_jax_jnp, rtol=1e-6, atol=1e-6)
    assert ops.RULE_COMPONENT_WEIGHTS == jax_ops.RULE_COMPONENT_WEIGHTS


def test_wrappers_check_their_inputs():
    weights, _, (peers, cache, ml) = _serving(20)
    mlp = ops.ServingMLP(weights, device="cpu")
    mat = torch.from_numpy(cache.matrix_snapshot()[1])
    s = torch.tensor([1, 2, 3], dtype=torch.int32)
    e = torch.zeros((3, 8), dtype=torch.float32)
    with pytest.raises(TypeError):
        ops.fused_gather_mlp_score(mat, s.long(), s, e, mlp)
    with pytest.raises(TypeError):
        ops.fused_gather_mlp_score(mat, s, s, e.double(), mlp)
    with pytest.raises(ValueError):
        ops.fused_gather_mlp_score(mat, s, s, torch.zeros((2, 8)), mlp)
    with pytest.raises(ValueError):
        ops.fused_gather_mlp_score(mat[:, :8].contiguous(), s, s, e, mlp)
    with pytest.raises(TypeError):
        ops.rule_sum(torch.zeros((3, 6), dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.rule_sum(torch.zeros((3, 5)))
    fused = ops.FusedMLPScorer(cache, weights, device="cpu")
    with pytest.raises(ValueError):
        fused.score(np.zeros((2, 8), np.float32),
                    src_buckets=np.array([0, cache.max_hosts]),
                    dst_buckets=np.array([0, 0]))


def test_plain_versions_count_no_launches():
    weights, _, (peers, cache, ml) = _serving(20)
    before = dict(ops.LAUNCHES)
    fused = ops.FusedMLPScorer(cache, weights, device="cpu")
    edge, slots, cslot, _, _ = ml._featurize_slots(peers[1:6], peers[0])
    fused.score(edge, src_buckets=slots, dst_buckets=np.full(5, cslot))
    ops.rule_weighted_sum(np.ones((4, 6), np.float32), device="cpu")
    assert ops.LAUNCHES == before


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    weights = _weights(0)
    with pytest.raises(RuntimeError):
        ops.FusedMLPScorer(HostFeatureCache(max_hosts=8), weights)
    with pytest.raises(RuntimeError):
        ops.rule_weighted_sum(np.ones((2, 6), np.float32))
    with pytest.raises(RuntimeError):
        ops.ServingMLP(weights, device="cuda")
