"""Port parity: the segment sum (K3) and the neighbor gather whose
backward it is, ``dragonfly2_tpu_torch/ops/segment.py`` against
``dragonfly2_tpu/ops/pallas_segment.py`` (Pallas in interpret mode) and
both packages' ``ops/aggregate.py`` oracles.

On the CPU the port's wrapper takes K3's plain version.  The kernel's
host prep (``kernel_runs``) is held here by a numpy emulation of the
kernel's two passes; the kernel itself is held to the plain version on
the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

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


def _emulate_kernel(values: np.ndarray, plan: seg.SegmentPlan, presorted: bool) -> np.ndarray:
    """The CUDA kernel's two passes over the plan's work items, in numpy:
    pass 1 sums each item's bucketed range in order into the output row
    or its partial row, pass 2 sums each split segment's partials.  Rows
    never written stay NaN, so a segment the items miss fails."""
    r = {k: v.numpy() for k, v in plan.runs.items()}
    perm, w = plan.perm.numpy(), plan.w.numpy()
    d = values.shape[1]
    out = np.full((plan.num_segments, d), np.nan, np.float32)
    part = np.full((plan.n_partials, d), np.nan, np.float32)
    for i in range(len(r["item_seg"])):
        acc = np.zeros(d, np.float32)
        for e in range(r["item_lo"][i], r["item_hi"][i]):
            acc += w[e] * values[e if presorted else perm[e]]
        if r["item_slot"][i] < 0:
            out[r["item_seg"][i]] = acc
        else:
            part[r["item_slot"][i]] = acc
    for b in range(len(r["long_seg"])):
        out[r["long_seg"][b]] = part[r["long_first"][b] : r["long_first"][b + 1]].sum(0)
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("max_run", [1, 7, 256])
def test_kernel_work_items_cover_every_segment_once(case, max_run):
    ids, n = _ids(case)
    vals = np.random.default_rng(4).normal(size=(len(ids), 5)).astype(np.float32)
    plan = seg.build_plan(ids, n, node_block=128, edge_block=128, max_run=max_run, device="cpu")
    runs = {k: v.numpy() for k, v in plan.runs.items()}
    assert np.all(runs["item_hi"] - runs["item_lo"] <= max_run)
    assert np.array_equal(np.unique(runs["item_seg"]), np.arange(n))
    # Zero edges: segment_sum hands the kernel an all-padding stream.
    presorted = len(ids) == 0
    if presorted:
        vals = np.zeros((plan.e_pad, 5), np.float32)
    want = seg._segment_sum_plain(
        torch.from_numpy(vals), plan, exact=True, presorted=presorted
    )
    _close(_emulate_kernel(vals, plan, presorted), want.numpy())


def test_the_gat_tables_padded_slots_split_node_0():
    """Every padded neighbor slot points at node 0: its run is split."""
    idx = np.zeros((400, 8), np.int64)
    idx[:, :3] = np.random.default_rng(6).integers(0, 400, (400, 3))
    plan = seg.build_plan(idx.reshape(-1), 400, device="cpu")
    runs = {k: v.numpy() for k, v in plan.runs.items()}
    assert list(runs["long_seg"]) == [0]
    assert runs["long_first"][1] == -(-int((idx == 0).sum()) // seg.MAX_RUN)


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
