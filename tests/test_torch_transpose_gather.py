"""Port parity: ``dragonfly2_tpu_torch/ops/transpose_gather.py`` against
``dragonfly2_tpu/ops/transpose_gather.py``.

``build_transpose_table`` is numpy in both packages: its arrays must be
equal, element for element and in dtype, on tables with padded slots,
empty rows and nodes whose out-degree spills past ``K_out``.  The
gather's backward is held in float32 within 1e-6 relative L2 (and 1e-6
× max |want| per element) of the JAX custom VJP and of a plain index
gather's backward (sums over the same rows in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import transpose_gather as jtg
from dragonfly2_tpu_torch.ops import transpose_gather as ttg

GRAD_TOL = 1e-6


def _table(case, n=60, k=5, seed=4):
    """[n, k] indices and mask.  ``hub``: a third of all real slots point
    at node 7, far past the 99.5th-percentile out-degree, so it spills."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k))
    mask = (rng.random((n, k)) < 0.7).astype(np.float32)
    mask[:3] = 0.0                       # empty rows
    idx[mask == 0] = 0                   # padded slots point at node 0
    if case == "hub":
        hub = rng.random((n, k)) < 0.35
        idx[hub & (mask > 0)] = 7
    return idx.astype(np.int32), mask


@pytest.mark.parametrize("cap", [None, 2, 16])
@pytest.mark.parametrize("case", ["random", "hub"])
def test_build_transpose_table_equals_the_jax_package(case, cap):
    idx, mask = _table(case)
    want = jtg.build_transpose_table(idx, mask, cap=cap)
    got = ttg.build_transpose_table(idx, mask, cap=cap)
    for name, a, b in zip(want._fields, got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy(), b), name
    if case == "hub" or cap == 2:
        assert got.over_pos.numel() > 0          # the spilled tail is exercised
    # Padded slots are not out-edges: node 0 collects only its real ones.
    real_to_0 = int(((idx == 0) & (mask > 0)).sum())
    assert int(got.tmask[0].sum()) + int((got.over_dst == 0).sum()) == real_to_0


@pytest.mark.parametrize("case", ["random", "hub"])
def test_gradient_matches_the_jax_vjp_and_the_index_backward(case):
    idx, mask = _table(case)
    n, d = idx.shape[0], 24
    rng = np.random.default_rng(9)
    h = rng.normal(size=(n, d)).astype(np.float32)
    # The cotangent is zero on padded slots, as the models' masks make it.
    ct = rng.normal(size=idx.shape + (d,)).astype(np.float32) * mask[..., None]

    jgather = jtg.make_transpose_gather(idx, mask)
    jout, vjp = jax.vjp(jgather, jnp.asarray(h))
    (jgrad,) = vjp(jnp.asarray(ct))

    gather = ttg.make_transpose_gather(idx, mask, device="cpu")
    th = torch.from_numpy(h).requires_grad_(True)
    out = gather(th)
    (grad,) = torch.autograd.grad(out, th, torch.from_numpy(ct))
    assert np.array_equal(out.detach().numpy(), np.asarray(jout))

    ih = torch.from_numpy(h).requires_grad_(True)
    iout = ih.index_select(0, torch.from_numpy(idx.reshape(-1)).long()).reshape(out.shape)
    (igrad,) = torch.autograd.grad(iout, ih, torch.from_numpy(ct))
    for want in (np.asarray(jgrad), igrad.numpy()):
        diff = grad.numpy().astype(np.float64) - want
        assert np.linalg.norm(diff) <= GRAD_TOL * np.linalg.norm(want)
        assert np.abs(diff).max() <= GRAD_TOL * np.abs(want).max()


def test_bf16_gradient_keeps_the_table_dtype():
    idx, mask = _table("hub")
    gather = ttg.make_transpose_gather(torch.from_numpy(idx), torch.from_numpy(mask),
                                       device="cpu")
    th = torch.randn((idx.shape[0], 8), dtype=torch.bfloat16, requires_grad=True)
    out = gather(th)
    (grad,) = torch.autograd.grad(out.float().sum(), th)
    assert out.dtype == grad.dtype == torch.bfloat16
    assert torch.isfinite(grad.float()).all()


def test_bad_inputs_are_refused():
    idx, mask = _table("random")
    with pytest.raises(ValueError):
        ttg.make_transpose_gather(idx.reshape(-1), mask, device="cpu")
    with pytest.raises(ValueError):
        ttg.make_transpose_gather(idx + 100, mask, device="cpu")
    gather = ttg.make_transpose_gather(idx, mask, device="cpu")
    with pytest.raises(ValueError):
        gather(torch.zeros((idx.shape[0] + 1, 4)))
