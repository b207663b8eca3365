"""Port parity: the flagship hop ranker, ``dragonfly2_tpu_torch/models/hop.py``
and ``train_hop_ranker`` against ``dragonfly2_tpu/models/hop.py`` and
``dragonfly2_tpu/trainer/train.py``, and its GNN scorer artifact in both
packages.

The port runs on the CPU (``device="cpu"``); the JAX package on its CPU
backend.  Parity runs carry flax's init into the port
(``load_flax_params``): a seed initializes the two packages with other
weights.

Tolerances, stated:
- ``precompute_hop_features``: 1e-5 absolute (float32 sums over K slots
  in another order);
- ``HopRanker`` forward and embeddings: 1e-5 absolute for a float32
  config; 2e-2 relative L2 for bfloat16 (XLA and torch round the bf16
  products and gelus at slightly other places);
- 6 train steps from the shared init, dropout 0: losses within 5e-3
  (bf16) and 1e-4 (float32) relative;
- trained weights, per leaf: ``‖port − jax‖ / ‖jax − initial‖``, the
  relative L2 of the two trainers' moves from the common start, within
  6e-2 (bf16) and 2e-4 (float32).  Measured on the CPU: at most 3.4e-2
  (bf16, the embedding table: a row moves in few steps, and a gradient
  element that bf16 rounding flips in sign moves Adam's update by 2 lr)
  and 4e-5 (float32).  Two planted faults in the port must read more than
  twice the limit, and do (~1.0 each): an embedding table that is never
  updated, and a precompute that aggregates one hop where the model
  expects two (the second hop's columns a copy of the first's);
- blobs across packages: 1e-6 absolute (the same numpy scorer on the same
  float32 weights); the exported scorer against the model's own
  validation predictions: 3e-2 × max(1, |score|) (the model's head runs
  in bf16, the scorer's in float32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models import gnn as jg
from dragonfly2_tpu.models import hop as jh
from dragonfly2_tpu.trainer import export as jexport
from dragonfly2_tpu.trainer import train as jtr
from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.models import hop as th
from dragonfly2_tpu_torch.models.mlp import warm_start_output_bias
from dragonfly2_tpu_torch.trainer import export
from dragonfly2_tpu_torch.trainer import train as ttr

N, K, D, B, M = 96, 6, 12, 32, 240
LOSS_RTOL = {"bf16": 5e-3, "f32": 1e-4}
MOVE_TOL = {"bf16": 6e-2, "f32": 2e-4}
EXPORT_TOL = 3e-2
CFG = dict(learning_rate=3e-3, weight_decay=0.1, epochs=2, warmup_steps=1, log_every=1,
           seed=5)
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _graph(seed=1):
    """A probe graph with padded slots (fewer in-edges than K for most
    nodes, none for some) and random RTTs, node features and edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 300)
    dst = rng.integers(0, N - 8, 300)          # the last 8 nodes: no in-edges
    rtt = rng.random(300).astype(np.float32) * 2.0
    nf = rng.normal(size=(N, D)).astype(np.float32)
    es = rng.integers(0, N, M)
    ed = (es + rng.integers(1, N, M)) % N
    y = (rng.normal(size=M) * 0.5 + 14.0).astype(np.float32)
    jt = jg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    tt = tg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    return nf, jt, tt, es, ed, y


def _configs(dtype, **kw):
    jd, td = DTYPES[dtype]
    base = {**dict(hidden=32, out_dim=16, node_embed_dim=8, dropout=0.0), **kw}
    return jh.HopConfig(dtype=jd, **base), th.HopConfig(dtype=td, **base)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v, np.float64)})
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def graph():
    return _graph()


@pytest.fixture(scope="module")
def hop_feats(graph):
    nf, jt, tt, *_ = graph
    jfeats = np.asarray(jh.precompute_hop_features(jnp.asarray(nf), jt, hops=2))
    tfeats = th.precompute_hop_features(torch.from_numpy(nf), tt, hops=2).numpy()
    return jfeats, tfeats


def test_precompute_hop_features_matches_jax(graph, hop_feats):
    nf, jt, tt, *_ = graph
    assert (np.asarray(jt.mask) == 0).any(axis=1).sum() > N // 2   # padded slots
    assert (np.asarray(jt.mask).sum(axis=1) == 0).sum() >= 8       # empty rows
    jfeats, tfeats = hop_feats
    assert tfeats.shape == jfeats.shape == (N, th.hop_feature_dim(D, 2))
    assert np.max(np.abs(tfeats - jfeats)) <= 1e-5


def _init(jcfg, jfeats, jt, n=2):
    """flax's HopRanker init, as the JAX trainer makes it for seed 5."""
    init_rng, _ = jax.random.split(jax.random.PRNGKey(CFG["seed"]))
    z = jnp.zeros((n,), jnp.int32)
    return _np(jh.HopRanker(jcfg).init(init_rng, jnp.asarray(jfeats), jt, z, z)["params"])


def _port(tcfg, params, feats):
    model = th.HopRanker(tcfg, num_nodes=feats.shape[0], in_dim=feats.shape[1])
    return tg.load_flax_params(model, params)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_embeddings_match_flax(graph, hop_feats, dtype):
    nf, jt, tt, es, ed, y = graph
    jfeats, tfeats = hop_feats
    jcfg, tcfg = _configs(dtype)
    params = _init(jcfg, jfeats, jt)
    model = _port(tcfg, params, tfeats)
    assert sorted(k.replace(".", "/") for k, _ in model.named_parameters()) == sorted(_flat(params))
    want = np.asarray(jh.HopRanker(jcfg).apply(
        {"params": params}, jnp.asarray(jfeats), jt, jnp.asarray(es), jnp.asarray(ed)))
    with torch.no_grad():
        got = model(torch.from_numpy(tfeats), tt, torch.from_numpy(es), torch.from_numpy(ed))
        emb = model(torch.from_numpy(tfeats), tt, None, None, return_embeddings=True)
        emb2 = model.embeddings(torch.from_numpy(tfeats), tt)
    want_emb = np.asarray(jh.HopRanker(jcfg).apply(
        {"params": params}, jnp.asarray(jfeats), jt, jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32), return_embeddings=True))
    assert got.dtype == emb.dtype == torch.float32
    assert torch.equal(emb, emb2)
    if dtype == "f32":
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5
        assert np.max(np.abs(emb.numpy() - want_emb)) <= 1e-5
    else:
        assert _rel_l2(got.numpy(), want) <= 2e-2
        assert _rel_l2(emb.numpy(), want_emb) <= 2e-2


def test_embed_init_and_warm_start_follow_flax(hop_feats):
    jfeats, tfeats = hop_feats
    jcfg, tcfg = _configs("f32", node_embed_dim=32)
    model = th.HopRanker(tcfg, num_nodes=N, in_dim=tfeats.shape[1],
                         generator=torch.Generator().manual_seed(0))
    # variance_scaling(1.0, "fan_in", "normal", out_axis=0): std 1/sqrt(32).
    std = float(model.HopEncoder_0.Embed_0.embedding.detach().std())
    assert abs(std - 32 ** -0.5) <= 0.1 * 32 ** -0.5
    enc_bias = model.HopEncoder_0.Dense_2.bias.detach().clone()
    warm_start_output_bias(model, 7.0)
    assert torch.equal(model.Dense_2.bias.detach(), torch.full((1,), 7.0))
    assert torch.equal(model.HopEncoder_0.Dense_2.bias.detach(), enc_bias)


def _jax_run(graph, hop_feats, dtype):
    """The JAX trainer from flax's init (seed 5)."""
    nf, jt, tt, es, ed, y = graph
    jfeats, _ = hop_feats
    jcfg, _ = _configs(dtype)
    jstate, jmet, jhist = jtr.train_hop_ranker(
        nf, jt, es, ed, y, model_config=jcfg, config=jtr.TrainConfig(**CFG),
        batch_size=B, hop_feats=jfeats,
    )
    _, train_idx = ttr.split_edges(M, CFG["seed"])
    return dict(dtype=dtype, p0=_init(jcfg, jfeats, jt), target_mean=float(y[train_idx].mean()),
                jstate=jstate, jmet=jmet, jhist=jhist, jcfg=jcfg)


def _port_run(graph, hop_feats, jax_run, fault=None):
    """The port's loop from the same init, optionally with a planted fault."""
    nf, jt, tt, es, ed, y = graph
    _, tcfg = _configs(jax_run["dtype"])
    feats = hop_feats[1].copy()
    if fault == "one_hop":
        feats[:, 3 * D:5 * D] = feats[:, D:3 * D]      # hop 2 := hop 1
    model = _port(tcfg, jax_run["p0"], feats)
    update = ttr.AdamW.update
    if fault == "frozen_embedding":
        emb = model.HopEncoder_0.Embed_0.embedding

        def frozen(self, grads):
            grads = [torch.zeros_like(g) if p is emb else g for p, g in zip(self.params, grads)]
            return update(self, grads)

        ttr.AdamW.update = frozen
    try:
        tstate, tmet, thist = ttr._train_graph_model(
            model, feats, tt, es, ed, y, None, ttr.TrainConfig(**CFG), "cpu", B)
    finally:
        ttr.AdamW.update = update
    return dict(jax_run, tstate=tstate, tmet=tmet, thist=thist, feats=feats)


@pytest.fixture(scope="module", params=["bf16", "f32"])
def jax_run(request, graph, hop_feats):
    return _jax_run(graph, hop_feats, request.param)


@pytest.fixture(scope="module")
def runs(graph, hop_feats, jax_run):
    return jax_run["dtype"], _port_run(graph, hop_feats, jax_run)


def _moves(r):
    """Per leaf, ‖port − jax‖ / ‖jax − start‖ after training."""
    start = _flat(r["p0"])
    # Both trainers warm-start the output bias before their first step.
    start["Dense_2/bias"] = start["Dense_2/bias"] + r["target_mean"]
    jp = _flat(_np(r["jstate"].params))
    tp = _flat(tg.to_flax_params(r["tstate"].model))
    return {k: float(np.linalg.norm(tp[k] - jp[k]) / max(np.linalg.norm(jp[k] - start[k]), 1e-12))
            for k in jp}


def test_train_losses_match_jax(runs):
    dtype, r = runs
    jl = np.array([h["loss"] for h in r["jhist"]])
    tl = np.array([h["loss"] for h in r["thist"]])
    assert len(jl) == len(tl) == 2 * ((M - M // 10) // B) == 12
    assert tl[-3:].mean() < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL[dtype])


def test_trained_weights_move_as_jax(runs):
    dtype, r = runs
    moves = _moves(r)
    assert len(moves) == 13
    assert max(moves.values()) <= MOVE_TOL[dtype], moves


@pytest.mark.parametrize("fault", ["frozen_embedding", "one_hop"])
def test_a_planted_fault_fails_the_weight_check(graph, hop_feats, jax_run, fault):
    r = _port_run(graph, hop_feats, jax_run, fault=fault)
    assert max(_moves(r).values()) > 2 * MOVE_TOL[jax_run["dtype"]]


def test_validation_and_export_match(runs, graph):
    dtype, r = runs
    nf, jt, tt, es, ed, y = graph
    jm, tm = r["jmet"].to_dict(), r["tmet"].to_dict()
    assert abs(tm["mae"] - jm["mae"]) <= 0.05 * jm["mae"]
    tstate = r["tstate"]
    buckets = np.arange(N) * 7 + 3
    scorer = export.export_gnn_scorer(tstate.model, r["feats"], tt, buckets)
    blob = export.gnn_scorer_to_bytes(scorer)
    val = tstate.val_idx
    kw = dict(src_buckets=buckets[es[val]], dst_buckets=buckets[ed[val]])
    got_t = export.load_scorer(blob).score(None, **kw)
    got_j = jexport.load_scorer(blob).score(None, **kw)
    assert np.max(np.abs(got_t - got_j)) <= 1e-6
    scale = max(1.0, float(np.abs(tstate.val_pred).max()))
    assert np.max(np.abs(got_t - tstate.val_pred)) <= EXPORT_TOL * scale
    # And the JAX package's export of its own run loads in the port.
    jblob = jexport.gnn_scorer_to_bytes(jexport.export_gnn_scorer(
        jh.HopRanker(r["jcfg"]), r["jstate"].params, r["feats"], jt, buckets))
    a = export.load_scorer(jblob).score(None, **kw)
    b = jexport.load_scorer(jblob).score(None, **kw)
    assert np.max(np.abs(a - b)) <= 1e-6


def test_train_hop_ranker_entry_point(graph):
    nf, jt, tt, es, ed, y = graph
    _, tcfg = _configs("bf16")
    state, metrics, hist = ttr.train_hop_ranker(
        nf, tt, es, ed, y, model_config=tcfg, config=ttr.TrainConfig(**CFG),
        device="cpu", batch_size=B)
    assert isinstance(state.model, th.HopRanker) and state.step == 12
    assert np.isfinite(metrics.mae) and len(hist) == 12
    with pytest.raises(ValueError, match="needs a mesh"):
        ttr.train_hop_ranker(nf, tt, es, ed, y, model_config=tcfg, device="cpu",
                             batch_size=B, node_sharding="model")
