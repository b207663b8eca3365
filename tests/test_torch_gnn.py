"""Port parity: the GAT ranker, ``dragonfly2_tpu_torch/models/gnn.py``
against ``dragonfly2_tpu/models/gnn.py``, with flax's params carried
across (``load_flax_params``), and the probe-graph inputs of
``records/synthetic.py``.

Sizes are small (N 200, K 8, hidden 16, 2 heads, embed 4, dropout 0).
With ``gather_fn`` both sides run the segment-sum backward: the Pallas
kernel in interpret mode and the port's plain version.

Tolerances: float32 models within 1e-5 (forward, scaled by max(1,
max |want|); gradients as the relative L2 norm over all parameters).
bfloat16 compute (the trainer's) within 2e-2 scaled (forward) and 3e-2
relative L2 / 3e-2 of the largest gradient per element (about four bf16
steps of it; the layer's weight gradients are bf16 products, one step
apart here and there): bf16 rounds at slightly other places in XLA's
fused elementwise code than in PyTorch's ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models import gnn as jg
from dragonfly2_tpu.models.mlp import warm_start_output_bias as jax_warm_start
from dragonfly2_tpu.ops.pallas_segment import make_neighbor_gather as jax_gather
from dragonfly2_tpu.records.synthetic import SyntheticCluster as JaxCluster
from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.models.mlp import warm_start_output_bias
from dragonfly2_tpu_torch.ops.segment import make_neighbor_gather
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster

N, K = 200, 8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}
GRAD_L2 = {"f32": 1e-5, "bf16": 3e-2}
GRAD_MAX = {"f32": 1e-5, "bf16": 3e-2}


def _graph(seed=11):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 800)
    dst = rng.integers(0, N, 800)
    rtt = rng.random(800).astype(np.float32)
    jt = jg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    tt = tg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    nf = rng.normal(size=(N, 12)).astype(np.float32)
    es = rng.integers(0, N, 64)
    ed = rng.integers(0, N, 64)
    y = rng.normal(size=64).astype(np.float32)
    return jt, tt, nf, es, ed, y


def _configs(dtype, gathered, jt):
    jdt, tdt = DTYPES[dtype]
    kw = dict(hidden=16, num_heads=2, node_embed_dim=4, dropout=0.0)
    jgf = jax_gather(np.asarray(jt.indices), N, edge_block=128, interpret=True) if gathered else None
    tgf = make_neighbor_gather(np.asarray(jt.indices), N, edge_block=128, device="cpu") if gathered else None
    return jg.GNNConfig(dtype=jdt, gather_fn=jgf, **kw), tg.GNNConfig(dtype=tdt, gather_fn=tgf, **kw)


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _grads_close(model, grads, jgrads, dtype):
    flat = tg._flatten(_as_numpy(jgrads))
    names = [name.replace(".", "/") for name, _ in model.named_parameters()]
    assert sorted(names) == sorted(flat)
    got = np.concatenate([g.detach().double().numpy().reshape(-1) for g in grads])
    want = np.concatenate([flat[k].astype(np.float64).reshape(-1) for k in names])
    assert np.linalg.norm(got - want) <= GRAD_L2[dtype] * np.linalg.norm(want)
    assert np.abs(got - want).max() <= GRAD_MAX[dtype] * np.abs(want).max()


@pytest.mark.parametrize(
    "case", ["random", "over_degree", "out_of_range", "feats_2d", "no_edges"]
)
def test_build_neighbor_table_equals_the_jax_package(case):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 50, 600 if case == "over_degree" else 120)
    dst = rng.integers(0, 50, len(src))
    feats = rng.random(len(src)).astype(np.float32)
    if case == "out_of_range":
        dst[:10] = np.array([-1, 50, 51, -7, 99, 3, 4, 5, 6, 7])
    if case == "feats_2d":
        feats = rng.random((len(src), 3)).astype(np.float32)
    if case == "no_edges":
        src, dst, feats = src[:0], dst[:0], feats[:0]
    want = jg.build_neighbor_table(50, src, dst, feats, max_neighbors=6,
                                   rng=np.random.default_rng(9))
    got = tg.build_neighbor_table(50, src, dst, feats, max_neighbors=6,
                                  rng=np.random.default_rng(9))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


def test_probe_graph_and_host_features_equal_the_jax_package():
    ours, theirs = SyntheticCluster(num_hosts=300, seed=4), JaxCluster(num_hosts=300, seed=4)
    assert np.array_equal(ours._host_feature_matrix(), theirs._host_feature_matrix())
    for a, b in zip(ours.probe_edges(density=16 / 299, seed=4),
                    theirs.probe_edges(density=16 / 299, seed=4)):
        assert np.array_equal(a, b)
    assert ours.rtt_ns(3, 7) == theirs.rtt_ns(3, 7)
    assert np.array_equal(ours._bandwidth_vec(np.arange(5), np.arange(5, 10)),
                          theirs._bandwidth_vec(np.arange(5), np.arange(5, 10)))


@pytest.mark.parametrize("gathered", [False, True], ids=["index", "k3_gather"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gat_layer_matches_flax(dtype, gathered):
    jt, tt, nf, *_ = _graph()
    jcfg, tcfg = _configs(dtype, gathered, jt)
    h = np.random.default_rng(5).normal(size=(N, 20)).astype(np.float32)
    jlayer = jg.GATLayer(8, 2, jcfg.dtype, jcfg.gather_fn)
    params = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(h), jt)["params"]
    cot = np.random.default_rng(6).normal(size=(N, 16)).astype(np.float32)

    def jloss(p):
        out = jlayer.apply({"params": p}, jnp.asarray(h), jt)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    layer = tg.GATLayer(20, 8, 2, 1, tcfg.dtype, tcfg.gather_fn)
    tg.load_flax_params(layer, _as_numpy(params))
    out = layer(torch.from_numpy(h), tt)
    assert out.dtype == tcfg.dtype
    _close(out.detach().float().numpy(), np.asarray(jout, np.float32), FWD_TOL[dtype])
    grads = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(), list(layer.parameters()))
    _grads_close(layer, grads, jgrads, dtype)


@pytest.mark.parametrize("gathered", [False, True], ids=["index", "k3_gather"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gat_ranker_forward_and_gradients_match_flax(dtype, gathered):
    jt, tt, nf, es, ed, y = _graph()
    jcfg, tcfg = _configs(dtype, gathered, jt)
    jmodel = jg.GATRanker(jcfg)
    args = (jnp.asarray(nf), jt, jnp.asarray(es), jnp.asarray(ed))
    params = jmodel.init(jax.random.PRNGKey(0), *args)["params"]

    def jloss(p):
        pred = jmodel.apply({"params": p}, *args)
        return jnp.mean((pred - y) ** 2), pred

    (jl, jpred), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = tg.GATRanker(tcfg, num_nodes=N, in_dim=12)
    tg.load_flax_params(model, _as_numpy(params))
    pred = model(torch.from_numpy(nf), tt, torch.from_numpy(es), torch.from_numpy(ed))
    assert pred.shape == (64,) and pred.dtype == torch.float32
    _close(pred.detach().numpy(), np.asarray(jpred), FWD_TOL[dtype])
    loss = torch.mean((pred - torch.from_numpy(y)) ** 2)
    assert abs(float(loss) - float(jl)) <= FWD_TOL[dtype] * max(1.0, float(jl))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _grads_close(model, grads, jgrads, dtype)
    emb = model(torch.from_numpy(nf), tt, None, None, return_embeddings=True)
    jemb = jmodel.apply({"params": params}, *args, return_embeddings=True)
    _close(emb.detach().numpy(), np.asarray(jemb), FWD_TOL[dtype])


def test_a_gather_fn_of_another_snapshot_is_refused():
    jt, tt, nf, es, ed, _ = _graph()
    rng = np.random.default_rng(3)
    small = tg.build_neighbor_table(50, rng.integers(0, 50, 99), rng.integers(0, 50, 99), max_neighbors=4)
    bad = make_neighbor_gather(small.indices.numpy(), 50, device="cpu")
    model = tg.GATRanker(tg.GNNConfig(hidden=16, num_heads=2, node_embed_dim=4, dropout=0.0,
                                      gather_fn=bad), num_nodes=N, in_dim=12)
    with pytest.raises(ValueError):
        model(torch.from_numpy(nf), tt, torch.from_numpy(es), torch.from_numpy(ed))


def test_flax_paths_map_one_for_one_and_a_missing_leaf_raises():
    jt, tt, nf, es, ed, _ = _graph()
    jcfg, tcfg = _configs("bf16", False, jt)
    params = _as_numpy(jg.GATRanker(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(nf), jt, jnp.asarray(es[:2]), jnp.asarray(ed[:2])
    )["params"])
    model = tg.GATRanker(tcfg, num_nodes=N, in_dim=12)
    tg.load_flax_params(model, params)
    back = tg._flatten(tg.to_flax_params(model))
    assert set(back) == set(tg._flatten(params))
    assert {"NodeEmbedding_0/embedding", "GATLayer_1/Dense_4/kernel", "Dense_3/bias"} <= set(back)
    for path, value in tg._flatten(params).items():
        assert np.array_equal(back[path], value)
    del params["Dense_3"]
    with pytest.raises(ValueError):
        tg.load_flax_params(model, params)


def test_warm_start_shifts_the_last_head_bias_as_the_jax_package():
    jt, tt, nf, es, ed, _ = _graph()
    jcfg, tcfg = _configs("bf16", False, jt)
    params = jg.GATRanker(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(nf), jt, jnp.asarray(es[:2]), jnp.asarray(ed[:2])
    )["params"]
    want = _as_numpy(jax_warm_start(params, 17.25))
    model = tg.load_flax_params(tg.GATRanker(tcfg, num_nodes=N, in_dim=12), _as_numpy(params))
    warm_start_output_bias(model, 17.25)
    got = tg.to_flax_params(model)
    assert np.array_equal(got["Dense_3"]["bias"], want["Dense_3"]["bias"])
    assert np.array_equal(got["Dense_2"]["bias"], want["Dense_2"]["bias"])


def test_dropout_draws_from_the_generator():
    x = torch.ones((1000, 8), dtype=torch.bfloat16)
    a = tg.dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = tg.dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a[a != 0]
    assert torch.all(kept == torch.tensor(1 / 0.75, dtype=torch.bfloat16))
    assert 0.2 < float((a == 0).float().mean()) < 0.3
    assert torch.equal(tg.dropout(x, 0.0, None), x)
