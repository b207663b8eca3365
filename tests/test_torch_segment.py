"""Port parity: the segment sum (K3) and the neighbor gather whose
backward it is, ``dragonfly2_tpu_torch/ops/segment.py`` against
``dragonfly2_tpu/ops/pallas_segment.py`` (Pallas in interpret mode) and
both packages' ``ops/aggregate.py`` oracles.

On the CPU the port's wrapper takes K3's plain version.  The kernel's
host prep (``kernel_chunks``) is held here by a numpy emulation of the
kernel's two passes; the kernel itself is held to the plain version on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
The chunk planner (``kernel_chunks``) is held to its contract directly.

Tolerances: 1e-5 × max(1, max |want|) against the Pallas kernel in
both modes — both round the values to bf16 the same way with
``exact=False`` and sum in f32 (the plain version in float64, rounded
once); the gather's gradient likewise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import aggregate as jagg
from dragonfly2_tpu.ops import pallas_segment as jseg
from dragonfly2_tpu_torch.ops import aggregate as tagg
from dragonfly2_tpu_torch.ops import segment as seg

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    assert float(np.abs(got - want).max(initial=0.0)) <= tol * scale


def _ids(case):
    rng = np.random.default_rng(1)
    if case == "random":
        return rng.integers(0, 300, 1000), 300
    if case == "hot_node_0":
        ids = rng.integers(0, 300, 1000)
        ids[:600] = 0
        return ids, 300
    if case == "empty_node_block":
        return np.array([5, 5, 6, 200, 520]), 600
    return np.zeros(0, np.int64), 300


CASES = ["random", "hot_node_0", "empty_node_block", "zero_edges"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("blocks", [(128, 128), (256, 512)])
def test_bucket_edges_by_block_equals_the_jax_package(case, blocks):
    ids, n = _ids(case)
    nb, eb = blocks
    want = jseg.bucket_edges_by_block(ids, n, node_block=nb, edge_block=eb)
    got = seg.bucket_edges_by_block(ids, n, node_block=nb, edge_block=eb)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("exact", [True, False])
def test_segment_sum_matches_the_pallas_kernel(case, exact):
    ids, n = _ids(case)
    vals = np.random.default_rng(2).normal(size=(len(ids), 24)).astype(np.float32)
    want = np.asarray(jseg.segment_sum_pallas(
        jnp.asarray(vals), ids, n, node_block=128, edge_block=128, exact=exact,
        interpret=True,
    ))
    got = seg.segment_sum(
        torch.from_numpy(vals), ids, n, node_block=128, edge_block=128, exact=exact
    )
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    if case == "zero_edges":
        assert not bool(got.any())


def test_bf16_values_sum_as_the_pallas_kernel_sums_them():
    ids, n = _ids("hot_node_0")
    vals = np.random.default_rng(3).normal(size=(len(ids), 44)).astype(np.float32)
    v16 = jnp.asarray(vals, jnp.bfloat16)
    want = np.asarray(jseg.segment_sum_pallas(
        v16, ids, n, node_block=128, edge_block=128, exact=False, interpret=True,
    ))
    got = seg.segment_sum(
        torch.from_numpy(vals).to(torch.bfloat16), ids, n, node_block=128,
        edge_block=128, exact=False,
    )
    _close(got.numpy(), want)


def test_presorted_values_skip_the_permutation():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 200, 500)
    vals = rng.normal(size=(500, 16)).astype(np.float32)
    perm, *_ = seg.bucket_edges_by_block(ids, 200, node_block=128, edge_block=128)
    pre = vals[perm]
    want = np.asarray(jseg.segment_sum_pallas(
        jnp.asarray(pre), ids, 200, presorted=True, node_block=128,
        edge_block=128, exact=True, interpret=True,
    ))
    got = seg.segment_sum(
        torch.from_numpy(pre), ids, 200, presorted=True, node_block=128,
        edge_block=128, exact=True,
    )
    _close(got.numpy(), want)
    _close(got.numpy(), np.asarray(jagg.segment_sum(jnp.asarray(vals), jnp.asarray(ids), 200)), 1e-4)
    with pytest.raises(ValueError):
        seg.segment_sum(torch.from_numpy(vals), ids, 200, presorted=True)


def test_mismatched_value_rows_are_refused():
    with pytest.raises(ValueError):
        seg.segment_sum(torch.ones((3, 4)), np.array([0, 1]), 10)
    with pytest.raises(TypeError):
        seg.segment_sum(torch.ones((2, 4), dtype=torch.float64), np.array([0, 1]), 10)


def _emulate_kernel(values: np.ndarray, plan: seg.SegmentPlan, presorted: bool,
                   half: bool = False) -> np.ndarray:
    """The CUDA kernel's two passes over the plan's chunks, in numpy f32
    and in the kernel's order: pass 1 walks each chunk's edges, adding
    each value row (with ``half``, even and odd edges of the chunk into
    two sums, as the half-warps of D <= 64 do) and writing a segment's
    row, and zero rows for the empty segments before the next, when the
    segment id changes; pass 2 adds each long segment's partials: lane
    row r of warp w sums partials 4w + r, 4w + r + 128, ..., the four
    lane rows are added as (0 + 1) + (2 + 3), then the 32 warps in order.
    Rows never written stay NaN, so a segment the chunks miss fails."""
    c = {k: v.numpy() for k, v in plan.chunks.items()}
    rows = c["edge_pos"] if presorted else c["edge_row"]
    d = values.shape[1]
    out = np.full((plan.num_segments, d), np.nan, np.float32)
    part = np.full((plan.n_partials, d), np.nan, np.float32)
    for i in range(len(c["chunk_lo"])):
        lo, hi = c["chunk_lo"][i], c["chunk_hi"][i]
        slot = c["chunk_slot"][i]
        cur = c["chunk_seg_lo"][i]
        acc = np.zeros((2, d), np.float32)

        def close(nxt):
            nonlocal cur
            row = acc[0] + acc[1]
            if slot < 0:
                out[cur] = row
                out[cur + 1 : nxt] = 0.0
            else:
                part[slot] = row
            acc[:] = 0.0
            cur = nxt

        for e in range(lo, hi):
            if c["edge_seg"][e] != cur:
                close(c["edge_seg"][e])
            acc[(e - lo) % 2 if half else 0] += values[rows[e]]
        close(c["chunk_seg_hi"][i])
    for b in range(len(c["long_seg"])):
        p = part[c["long_first"][b] : c["long_first"][b + 1]]
        def lane_sum(first):
            acc = np.zeros(d, np.float32)
            for row in p[first::128]:
                acc += row
            return acc

        warp_sums = []
        for w in range(32):
            r0, r1, r2, r3 = (lane_sum(4 * w + r) for r in range(4))
            warp_sums.append((r0 + r1) + (r2 + r3))
        total = np.zeros(d, np.float32)
        for ws in warp_sums:
            total += ws
        out[c["long_seg"][b]] = total
    return out


def _chunk_invariants(plan: seg.SegmentPlan, max_run: int):
    """The planner's contract: the walk is every real edge of the
    bucketed stream once, in order; the chunks cut the walk into
    consecutive ranges of at most ``CHUNK_EDGES`` edges; every segment
    lies in exactly one chunk or is a long segment split into runs of at
    most ``max_run``, and each chunk holds whole segments only."""
    c = {k: v.numpy() for k, v in plan.chunks.items()}
    w = plan.w.numpy()
    real = np.nonzero(w > 0)[0]
    seg_of = (plan.block_node.numpy()[real // plan.edge_block].astype(np.int64)
              * plan.node_block + plan.dstl.numpy()[real])
    real = real[seg_of < plan.num_segments]
    assert np.array_equal(c["edge_pos"], real)
    assert np.array_equal(c["edge_row"], plan.perm.numpy()[real])
    lo, hi = c["chunk_lo"], c["chunk_hi"]
    assert lo[0] == 0 and hi[-1] == len(real) and np.array_equal(lo[1:], hi[:-1])
    assert np.all(hi - lo <= seg.CHUNK_EDGES)
    short = c["chunk_slot"] < 0
    owner = np.full(plan.num_segments, -1)
    for i in np.nonzero(short)[0]:
        assert np.all(owner[c["chunk_seg_lo"][i] : c["chunk_seg_hi"][i]] == -1)
        owner[c["chunk_seg_lo"][i] : c["chunk_seg_hi"][i]] = i
        edge_segs = c["edge_seg"][lo[i] : hi[i]]
        assert np.all((edge_segs >= c["chunk_seg_lo"][i]) & (edge_segs < c["chunk_seg_hi"][i]))
    assert np.array_equal(np.nonzero(owner < 0)[0], c["long_seg"])
    counts = np.bincount(c["edge_seg"], minlength=plan.num_segments)
    assert np.all(counts[owner >= 0] <= max_run) and np.all(counts[c["long_seg"]] > max_run)
    for b, s in enumerate(c["long_seg"]):
        runs = np.arange(c["long_first"][b], c["long_first"][b + 1])
        assert np.array_equal(c["chunk_slot"][~short][runs], runs)
        assert np.all(c["chunk_seg_lo"][~short][runs] == s)
        assert np.all((hi - lo)[~short][runs] <= max_run)
        assert (hi - lo)[~short][runs].sum() == counts[s]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("max_run", [1, 7, 256])
def test_kernel_work_items_cover_every_segment_once(case, max_run):
    ids, n = _ids(case)
    vals = np.random.default_rng(4).normal(size=(len(ids), 5)).astype(np.float32)
    plan = seg.build_plan(ids, n, node_block=128, edge_block=128, max_run=max_run, device="cpu")
    _chunk_invariants(plan, max_run)
    # Zero edges: segment_sum hands the kernel an all-padding stream.
    presorted = len(ids) == 0
    if presorted:
        vals = np.zeros((plan.e_pad, 5), np.float32)
    want = seg._segment_sum_plain(
        torch.from_numpy(vals), plan, exact=True, presorted=presorted
    )
    for half in (False, True):
        _close(_emulate_kernel(vals, plan, presorted, half), want.numpy())


def _boundary_ids():
    """Segments that end exactly on a chunk boundary (eight of 32 edges
    fill the first chunk), segments of MAX_RUN and MAX_RUN + 1 edges, runs
    of empty segments between full ones, and a tail of empty segments."""
    counts = [32] * 8 + [0, 0, 0, 5, 0, 1, seg.MAX_RUN, 0, 0, seg.MAX_RUN + 1, 3,
                         seg.CHUNK_EDGES - 3, 2 * seg.MAX_RUN + 5, 0, 7] + [0] * 600
    ids = np.repeat(np.arange(len(counts)), counts)
    return np.random.default_rng(10).permutation(ids), len(counts), counts


def test_chunk_plan_at_its_boundaries():
    ids, n, counts = _boundary_ids()
    plan = seg.build_plan(ids, n, node_block=128, edge_block=128, device="cpu")
    _chunk_invariants(plan, seg.MAX_RUN)
    c = {k: v.numpy() for k, v in plan.chunks.items()}
    short = c["chunk_slot"] < 0
    spans = list(zip(c["chunk_seg_lo"][short], c["chunk_seg_hi"][short],
                     (c["chunk_hi"] - c["chunk_lo"])[short]))
    # The first chunk is exactly the eight 32-edge segments, and the empty
    # segments after them ride along.
    assert (c["chunk_lo"][0], c["chunk_hi"][0]) == (0, seg.CHUNK_EDGES)
    assert spans[0] == (0, 11, seg.CHUNK_EDGES)
    # MAX_RUN edges stay whole in one chunk; MAX_RUN + 1 and more split.
    assert (14, 17, seg.MAX_RUN) in spans
    assert list(c["long_seg"]) == [17, 20]
    assert list(np.diff(c["long_first"])) == [2, 3]
    # 3 + (CHUNK_EDGES - 3) edges end exactly on the chunk's limit.
    assert (18, 20, seg.CHUNK_EDGES) in spans
    # A chunk writes at most CHUNK_SEGMENTS segments: the empty tail spans
    # several chunks.
    assert np.all(c["chunk_seg_hi"] - c["chunk_seg_lo"] <= seg.CHUNK_SEGMENTS)
    vals = np.random.default_rng(11).normal(size=(len(ids), 6)).astype(np.float32)
    want = seg._segment_sum_plain(torch.from_numpy(vals), plan, exact=True, presorted=False)
    assert not bool(want[np.asarray(counts) == 0].any())
    for half in (False, True):
        _close(_emulate_kernel(vals, plan, False, half), want.numpy())


@pytest.mark.parametrize("max_run", [16, 64, 256])
def test_chunk_planner_takes_whole_segments_up_to_its_size(max_run):
    # 200 segments of 0-119 edges: a chunk holds a few, and with a small
    # max_run many are cut into runs.
    n = 200
    counts = np.random.default_rng(13).integers(0, 120, n)
    ids = np.random.default_rng(14).permutation(np.repeat(np.arange(n), counts))
    perm, dstl, w, block_node, _ = seg.bucket_edges_by_block(ids, n, node_block=128, edge_block=128)
    c = seg.kernel_chunks(dstl, w, block_node, n, node_block=128, edge_block=128,
                          max_run=max_run)
    assert np.array_equal(np.bincount(c["edge_seg"], minlength=n), counts)
    sizes = c["chunk_hi"] - c["chunk_lo"]
    segs = c["chunk_seg_hi"] - c["chunk_seg_lo"]
    assert np.all(sizes <= seg.CHUNK_EDGES) and np.all(segs <= seg.CHUNK_SEGMENTS)
    assert list(c["long_seg"]) == list(np.nonzero(counts > max_run)[0])
    # Greedy: the next segment would not have fit.
    for i in np.nonzero(c["chunk_slot"][:-1] < 0)[0]:
        nxt = c["chunk_seg_hi"][i]
        if nxt < n and counts[nxt] <= max_run and c["chunk_slot"][i + 1] < 0:
            assert sizes[i] + counts[nxt] > seg.CHUNK_EDGES
    with pytest.raises(ValueError):
        seg.kernel_chunks(dstl, w * 0.5, block_node, n, node_block=128, edge_block=128)
    with pytest.raises(ValueError):
        seg.kernel_chunks(dstl, w, block_node, n, node_block=128, edge_block=128,
                          max_run=seg.CHUNK_EDGES + 1)


@pytest.mark.parametrize("exact", [True, False])
def test_a_reading_of_the_chunk_plan_equals_the_pallas_kernel(exact):
    ids, n, _ = _boundary_ids()
    vals = np.random.default_rng(12).normal(size=(len(ids), 12)).astype(np.float32)
    want = np.asarray(jseg.segment_sum_pallas(
        jnp.asarray(vals), ids, n, node_block=128, edge_block=128, exact=exact,
        interpret=True,
    ))
    plan = seg.build_plan(ids, n, node_block=128, edge_block=128, device="cpu")
    v = vals if exact else torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    for half in (False, True):
        _close(_emulate_kernel(v, plan, False, half), want)


def test_the_gat_tables_padded_slots_split_node_0():
    """Every padded neighbor slot points at node 0: its run is split."""
    idx = np.zeros((400, 8), np.int64)
    idx[:, :3] = np.random.default_rng(6).integers(0, 400, (400, 3))
    plan = seg.build_plan(idx.reshape(-1), 400, device="cpu")
    chunks = {k: v.numpy() for k, v in plan.chunks.items()}
    assert list(chunks["long_seg"]) == [0]
    assert chunks["long_first"][1] == -(-int((idx == 0).sum()) // seg.MAX_RUN)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_neighbor_gather_matches_the_jax_custom_vjp(dtype):
    rng = np.random.default_rng(7)
    n, k, d = 300, 8, 44
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[:100, 5:] = 0
    table = rng.normal(size=(n, d)).astype(np.float32)
    g = rng.normal(size=(n, k, d)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16

    jgather = jseg.make_neighbor_gather(idx, n, edge_block=128, interpret=True)
    jout, vjp = jax.vjp(jgather, jnp.asarray(table, jdt))
    (jgrad,) = vjp(jnp.asarray(g, jdt))

    gather = seg.make_neighbor_gather(idx, n, edge_block=128, device="cpu")
    t = torch.from_numpy(table).to(tdt).requires_grad_()
    out = gather(t)
    assert np.array_equal(out.detach().float().numpy(), np.asarray(jout, np.float32))
    out.backward(torch.from_numpy(g).to(tdt))
    assert t.grad.dtype == tdt
    _close(t.grad.float().numpy(), np.asarray(jgrad, np.float32))


def test_neighbor_gather_refuses_another_table():
    gather = seg.make_neighbor_gather(np.zeros((50, 4), np.int32), 50, device="cpu")
    with pytest.raises(ValueError):
        gather(torch.zeros((200, 8)))
    with pytest.raises(ValueError):
        seg.make_neighbor_gather(np.full((50, 4), 50), 50, device="cpu")


def test_a_non_cpu_tensor_never_takes_the_plain_version():
    plan = seg.build_plan(np.array([0, 1, 1]), 4, device="cpu")
    with pytest.raises(ValueError):
        seg.segment_sum_bucketed(torch.ones((3, 2), device="meta"), plan, exact=True)


def test_aggregate_oracles_match_the_jax_package():
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(400, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 400)
    for name in ("segment_sum", "segment_mean"):
        want = np.asarray(getattr(jagg, name)(jnp.asarray(vals), jnp.asarray(ids), 50))
        got = getattr(tagg, name)(torch.from_numpy(vals), torch.from_numpy(ids), 50)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(50, 6)).astype(np.float32)
    nbr = rng.integers(0, 50, (50, 4)).astype(np.int32)
    mask = (rng.random((50, 4)) < 0.7).astype(np.float32)
    want = np.asarray(jagg.masked_mean_aggregate(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask)))
    got = tagg.masked_mean_aggregate(torch.from_numpy(h), torch.from_numpy(nbr), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
