"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so these skip where no CUDA device
is available; on a machine with one (and without JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: K1 1e-5 scaled by max(1, max |score|) (f32, another sum
order, tanhf ulps); K2 1e-6; the fused scorer against the numpy scorer
1e-4.  K3 1e-5 scaled by max(1, max |sum|): both sides round the values
to bf16 the same way, the plain version sums in float64, the kernel in
f32 in its own order.
"""

from __future__ import annotations

import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(seed=0, dims=(32, 64, 64, 1)):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05,
        )
        for i in range(len(dims) - 1)
    ]


# Widths: the serving shape; a wider first layer; widths whose weight
# pieces are not all multiples of 16 bytes (b0, b1, W2 and W1's rows at
# 50x30); more than 128 second-layer units (several passes of quads).
K1_DIMS = {"64x64": (32, 64, 64, 1), "96x48": (32, 96, 48, 1), "60x36": (32, 60, 36, 1),
           "50x30": (32, 50, 30, 1), "40x160": (32, 40, 160, 1)}


@pytest.mark.parametrize("n", [1, 7, 8, 9, 31, 32, 33, 128, 129, 512, 4096])
@pytest.mark.parametrize("dims", list(K1_DIMS.values()), ids=list(K1_DIMS))
def test_k1_matches_its_plain_version(cuda, n, dims):
    import torch

    from dragonfly2_tpu_torch.ops import fused_score as ops

    rng = np.random.default_rng(n)
    mlp = ops.ServingMLP(_weights(1, dims), device=cuda)
    mat = torch.from_numpy(rng.standard_normal((65536, 12)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(rng.integers(0, 65536, n).astype(np.int32)).to(cuda)
    d = torch.from_numpy(rng.integers(0, 65536, n).astype(np.int32)).to(cuda)
    e = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(cuda)
    before = ops.LAUNCHES["fused_gather_mlp_score"]
    got = ops.fused_gather_mlp_score(mat, s, d, e, mlp)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_gather_mlp_score"] == before + 1
    want = ops._fused_score_plain(mat, s, d, e, mlp.w0c, mlp.w0p, mlp.w0e, mlp.b0,
                                  mlp.layers())
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_k1_scores_an_out_of_range_slot_nan(cuda):
    import torch

    from dragonfly2_tpu_torch.ops import fused_score as ops

    mlp = ops.ServingMLP(_weights(), device=cuda)
    mat = torch.zeros((16, 12), device=cuda)
    s = torch.tensor([0, 16, 3], dtype=torch.int32, device=cuda)
    e = torch.zeros((3, 8), device=cuda)
    got = ops.fused_gather_mlp_score(mat, s, torch.zeros_like(s), e, mlp).cpu()
    assert torch.isnan(got[1]) and torch.isfinite(got[[0, 2]]).all()


def test_k1_stress_over_store_like_rows(cuda, tmp_path):
    """2,000 seeded flushes of 1 to 1,024 rows (every pad boundary of K1's
    4-row blocks), slots over a 65,536-row matrix of the columnar store's
    rows, each flush launched 3 times back to back: every launch within
    1e-5 scaled of the plain version and bit-equal to the flush's first.
    A flush past the limit is saved for ``bench/k1_replay``."""
    from dragonfly2_tpu_torch.bench import k1_replay

    out = k1_replay.stress(cuda, flushes=2000, repeats=3, seed=0, save_dir=str(tmp_path))
    assert out["flushes"] == 2000 and out["rows_min"] == 1 and out["rows_max"] == 1024
    assert out["slots"] == 65536 and out["launches"] == 6000
    assert out["flushes_over_tol"] == 0 and out["max_err_scaled"] <= k1_replay.K1_TOL, out
    assert out["k1_bits_vary"] == 0, out


@pytest.mark.parametrize("n", [1, 512, 5000])
def test_k2_matches_its_plain_version(cuda, n):
    import torch

    from dragonfly2_tpu_torch.ops import fused_score as ops

    comp = torch.from_numpy(
        np.random.default_rng(n).standard_normal((n, 6)).astype(np.float32)
    ).to(cuda)
    got = ops.rule_sum(comp)
    torch.cuda.synchronize()
    want = ops._rule_sum_plain(comp, ops.RULE_COMPONENT_WEIGHTS)
    assert float((got - want).abs().max()) <= 1e-6


def test_fused_scorer_on_the_card_matches_the_numpy_scorer(cuda):
    from dragonfly2_tpu_torch.ops import fused_score as ops
    from dragonfly2_tpu_torch.scheduler import HostFeatureCache, MLEvaluator
    from dragonfly2_tpu_torch.sim.swarm import build_announce_swarm
    from dragonfly2_tpu_torch.trainer.export import MLPScorer

    weights = _weights(3)
    task, peers = build_announce_swarm(60, seed=3)
    cache = HostFeatureCache(max_hosts=512)
    ref = MLEvaluator(MLPScorer(weights=weights), feature_cache=cache)
    fused = ops.FusedMLPScorer(cache, weights, device=cuda)
    ml = MLEvaluator(fused, feature_cache=cache)
    edge, slots, cslot, _, _ = ml._featurize_slots(peers[1:25], peers[0])
    got = fused.score(edge, src_buckets=slots, dst_buckets=np.full(len(slots), cslot))
    feats, _, _ = ref._featurize_batch(peers[1:25], peers[0])
    np.testing.assert_allclose(got, MLPScorer(weights=weights).score(feats),
                               rtol=1e-4, atol=1e-4)
    ranked = ml.evaluate_parents(peers[1:25], peers[0], task.total_piece_count)
    assert ml.degrades == 0 and len(ranked) == 24


def test_fused_scorer_makes_one_upload_and_one_download_a_flush(cuda):
    """With the mirror current, a flush copies once to the card (slot ids
    and edge block in one pinned buffer) and once back (the scores), as
    the profiler sees the copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dragonfly2_tpu_torch.ops import fused_score as ops
    from dragonfly2_tpu_torch.scheduler import HostFeatureCache, MLEvaluator
    from dragonfly2_tpu_torch.sim.swarm import build_announce_swarm
    from dragonfly2_tpu_torch.trainer.export import MLPScorer

    weights = _weights(4)
    _, peers = build_announce_swarm(60, seed=4)
    cache = HostFeatureCache(max_hosts=512)
    fused = ops.FusedMLPScorer(cache, weights, device=cuda)
    ml = MLEvaluator(fused, feature_cache=cache)
    ref = MLEvaluator(MLPScorer(weights=weights), feature_cache=cache)
    edge, slots, cslot, _, _ = ml._featurize_slots(peers[1:40], peers[0])
    dst = np.full(len(slots), cslot)
    fused.score(edge, src_buckets=slots, dst_buckets=dst)      # syncs the mirror
    up, down = fused.uploads, fused.downloads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = fused.score(edge, src_buckets=slots, dst_buckets=dst)
    copies = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA and "Memcpy" in e.name]
    assert sum("HtoD" in c for c in copies) == 1, copies
    assert sum("DtoH" in c for c in copies) == 1, copies
    assert (fused.uploads, fused.downloads) == (up + 1, down + 1)
    feats, _, _ = ref._featurize_batch(peers[1:40], peers[0])
    np.testing.assert_allclose(got, MLPScorer(weights=weights).score(feats),
                               rtol=1e-4, atol=1e-4)


def _k3_case(cuda, e, d, n, dtype, exact, *, hot=0, node_block=256, edge_block=512,
             ids=None, offset=0):
    """K3 against its plain version on seeded values; ``hot`` edges all
    go to segment 0 (the GAT's padded-slot run).  ``offset`` > 0 starts
    the values that many elements into their buffer, so rows are not
    aligned to a vector load."""
    import torch

    from dragonfly2_tpu_torch.ops import segment as seg

    rng = np.random.default_rng(e + d)
    if ids is None:
        ids = rng.integers(0, n, e)
        ids[:hot] = 0
    e = len(ids)
    flat = torch.from_numpy(rng.standard_normal(e * d + offset).astype(np.float32)).to(dtype)
    vals = flat.to(cuda)[offset:].view(e, d)
    assert vals.data_ptr() % 8 == (2 * offset if dtype == torch.bfloat16 else 4 * offset) % 8
    plan = seg.build_plan(ids, n, node_block=node_block, edge_block=edge_block, device=cuda)
    before = seg.LAUNCHES["segment_sum"]
    got = seg.segment_sum_bucketed(vals, plan, exact=exact)
    torch.cuda.synchronize()
    assert seg.LAUNCHES["segment_sum"] == before + 1
    want = seg._segment_sum_plain(vals, plan, exact=exact, presorted=False)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("d", [1, 3, 44, 45, 64, 65, 128, 200, 256])
@pytest.mark.parametrize("dtype,exact", [("bf16", False), ("f32", True), ("f32", False)])
def test_k3_matches_its_plain_version(cuda, d, dtype, exact):
    import torch

    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    _k3_case(cuda, 20000, d, 3000, dt, exact, hot=5000)


@pytest.mark.parametrize("d", [44, 45, 128])
@pytest.mark.parametrize("dtype,exact", [("bf16", False), ("f32", True)])
def test_k3_at_chunk_boundaries(cuda, d, dtype, exact):
    """Segments ending exactly on a chunk's limit, of MAX_RUN and MAX_RUN
    + 1 edges, and runs of empty segments between full ones."""
    import torch

    from dragonfly2_tpu_torch.ops import segment as seg

    counts = [32] * 8 + [0, 0, 0, 5, 0, 1, seg.MAX_RUN, 0, 0, seg.MAX_RUN + 1, 3,
                         seg.CHUNK_EDGES - 3, 2 * seg.MAX_RUN + 5, 0, 7] + [0] * 600
    ids = np.random.default_rng(d).permutation(np.repeat(np.arange(len(counts)), counts))
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    _k3_case(cuda, 0, d, len(counts), dt, exact, ids=ids, node_block=128, edge_block=128)


@pytest.mark.parametrize("d", [44, 64, 128])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k3_takes_rows_not_aligned_to_a_vector(cuda, d, dtype):
    import torch

    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    _k3_case(cuda, 20000, d, 3000, dt, False, hot=5000, offset=1)


def test_k3_at_the_gat_shape(cuda):
    """1.6M edges into 100k segments with ~158k on node 0, D = 128 bf16."""
    import torch

    _k3_case(cuda, 1_600_000, 128, 100_000, torch.bfloat16, False, hot=158_638)


def test_k3_zero_edges_and_empty_node_blocks_are_zero(cuda):
    import torch

    from dragonfly2_tpu_torch.ops import segment as seg

    got = seg.segment_sum(torch.zeros((0, 8), device=cuda), np.zeros(0, np.int64), 300)
    assert got.shape == (300, 8) and not bool(got.any())
    vals = torch.ones((4, 8), device=cuda)
    got = seg.segment_sum(vals, np.array([5, 5, 6, 200]), 600).cpu()
    assert float(got[5].sum()) == 16.0 and float(got[200].sum()) == 8.0
    assert float(got.sum()) == 32.0


def test_k3_neighbor_gather_backward(cuda):
    import torch

    from dragonfly2_tpu_torch.ops import segment as seg

    rng = np.random.default_rng(7)
    n, k, d = 3000, 16, 44
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[: n // 3, 8:] = 0
    gather = seg.make_neighbor_gather(idx, n, device=cuda)
    table = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        torch.bfloat16).to(cuda).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((n, k, d)).astype(np.float32)).to(
        torch.bfloat16).to(cuda)
    out = gather(table)
    assert torch.equal(out, table.detach()[torch.from_numpy(idx).long().to(cuda)])
    before = seg.LAUNCHES["segment_sum"]
    out.backward(g)
    assert seg.LAUNCHES["segment_sum"] == before + 1
    want = torch.zeros((n, d), dtype=torch.float64, device=cuda).index_add_(
        0, torch.from_numpy(idx.reshape(-1)).long().to(cuda), g.reshape(-1, d).double())
    assert table.grad.dtype == torch.bfloat16
    err = float((table.grad.double() - want).abs().max())
    assert err <= 1e-2 * max(1.0, float(want.abs().max()))
