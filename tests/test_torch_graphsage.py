"""Port parity: GraphSAGE (BASELINE configs[1]), ``SAGELayer`` /
``GraphSAGE`` in ``dragonfly2_tpu_torch/models/gnn.py`` and
``train_graphsage`` in ``dragonfly2_tpu_torch/trainer/train.py``, against
``dragonfly2_tpu/models/gnn.py`` and ``dragonfly2_tpu/trainer/train.py``.

Sizes are small (N 64, K 6, D 12, hidden 16, out 8, embed 4).  flax's
params are carried across (``load_flax_params``); the JAX trainer's inline
edge model is rebuilt here with the same structure and names, so its
init is the one the JAX trainer makes for the seed.

Tolerances, stated:
- forward, float32: 1e-5 × max(1, max |want|); bfloat16: 2e-2 relative
  L2 (XLA and PyTorch round the bf16 products, sums and gelus at slightly
  other places); gradients 1e-5 (f32) and 3e-2 (bf16) relative L2;
- the three gathers (index, K3 on its plain CPU path, transpose) give the
  same forward, bit for bit; their parameter gradients agree within 1e-6
  relative L2 in float32 (index and transpose; K3's backward rounds its
  cotangent to bf16, so it is held in the bf16 model) and 2e-2 in
  bfloat16 (the index gather's backward accumulates in bf16, K3 sums in
  float32, the transpose gather's sum rounds once);
- 6 train steps from the shared init, dropout 0: losses within 5e-3
  (bf16) and 1e-4 (f32) relative;
- trained leaves: ``‖port − jax‖ / ‖jax − start‖`` within 6e-2 (bf16)
  and 2e-4 (f32).  Two planted faults must read above twice the limit:
  an aggregate ``Dense_1`` of the first layer that is never updated, and
  a mean that ignores the mask (padded slots averaged in);
- the warm-started output bias equals JAX's exactly.

Run as a script (``python tests/test_torch_graphsage.py``), the file
prints ``seed_study``: the full-width validation MAE of both packages'
``train_graphsage`` over several seeds on configs[1]'s probe graph, and
one run from flax's init carried into the port.
"""

from __future__ import annotations

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models import gnn as jg
from dragonfly2_tpu.models.mlp import warm_start_output_bias as jax_warm_start
from dragonfly2_tpu.trainer import train as jtr
from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.models.mlp import warm_start_output_bias
from dragonfly2_tpu_torch.ops.segment import make_neighbor_gather
from dragonfly2_tpu_torch.ops.transpose_gather import make_transpose_gather
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.trainer import train as ttr

N, K, D, E = 64, 6, 12, 400
B = 120                                 # 360 train edges: 3 steps an epoch
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}
GRAD_TOL = {"f32": 1e-5, "bf16": 3e-2}
GATHER_TOL = {"f32": 1e-6, "bf16": 2e-2}
LOSS_RTOL = {"bf16": 5e-3, "f32": 1e-4}
MOVE_TOL = {"bf16": 6e-2, "f32": 2e-4}
CFG = dict(learning_rate=3e-3, weight_decay=0.1, epochs=2, warmup_steps=1, log_every=1,
           seed=5)
MODEL_KW = dict(hidden=16, out_dim=8, num_layers=2, node_embed_dim=4, dropout=0.0)


class _JaxSAGEEdge(nn.Module):
    """The JAX ``train_graphsage``'s inline ``_SAGEEdgeModel``, verbatim."""

    cfg: jg.GNNConfig

    @nn.compact
    def __call__(self, node_feats, table, src, dst, *, train: bool = False):
        emb = jg.GraphSAGE(self.cfg)(node_feats, table, train=train)
        s = jnp.take(emb, src, axis=0)
        d = jnp.take(emb, dst, axis=0)
        x = jnp.concatenate([s, d, s * d], axis=-1).astype(self.cfg.dtype)
        x = nn.gelu(nn.Dense(self.cfg.hidden, dtype=self.cfg.dtype, param_dtype=jnp.float32)(x))
        return nn.Dense(1, dtype=jnp.float32, param_dtype=jnp.float32)(x)[..., 0]


def _graph(seed=1):
    """A probe graph with padded slots and nodes with no in-edges; its
    edges are also the supervised edges (``log1p(rtt / 1e6)``)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N - 4, E)              # the last 4 nodes: no in-edges
    rtt = rng.uniform(1e6, 4e8, E)
    jt = jg.build_neighbor_table(N, src, dst, rtt / 1e9, max_neighbors=K)
    tt = tg.build_neighbor_table(N, src, dst, rtt / 1e9, max_neighbors=K)
    nf = rng.normal(size=(N, D)).astype(np.float32)
    y = np.log1p(rtt / 1e6).astype(np.float32)
    return nf, jt, tt, src, dst, y


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _configs(dtype, **kw):
    jd, td = DTYPES[dtype]
    base = {**MODEL_KW, **kw}
    return jg.GNNConfig(dtype=jd, **base), tg.GNNConfig(dtype=td, **base)


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


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if dtype == "f32":
        assert np.abs(got - want).max() <= FWD_TOL[dtype] * max(1.0, np.abs(want).max())
    else:
        assert _rel_l2(got, want) <= FWD_TOL[dtype]


def _sage_params(jcfg, nf, jt):
    return _np(jg.GraphSAGE(jcfg).init(jax.random.PRNGKey(2), jnp.asarray(nf), jt)["params"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_graphsage_forward_and_gradients_match_flax(graph, dtype):
    nf, jt, tt, *_ = graph
    jcfg, tcfg = _configs(dtype)
    params = _sage_params(jcfg, nf, jt)
    model = tg.load_flax_params(tg.GraphSAGE(tcfg, num_nodes=N, in_dim=D), params)
    assert sorted(k.replace(".", "/") for k, _ in model.named_parameters()) == sorted(_flat(params))
    assert {"NodeEmbedding_0/embedding", "SAGELayer_1/Dense_2/kernel", "Dense_0/bias"} <= set(
        _flat(params))
    cot = np.random.default_rng(6).normal(size=(N, MODEL_KW["out_dim"])).astype(np.float32)

    def jloss(p):
        out = jg.GraphSAGE(jcfg).apply({"params": p}, jnp.asarray(nf), jt)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = model(torch.from_numpy(nf), tt)
    assert out.shape == (N, MODEL_KW["out_dim"]) and out.dtype == torch.float32
    _close(out.detach().numpy(), jout, dtype)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), list(model.parameters()))
    jflat = _flat(_np(jgrads))
    got = np.concatenate([g.double().numpy().reshape(-1) for g in grads])
    want = np.concatenate([jflat[n.replace(".", "/")].reshape(-1)
                           for n, _ in model.named_parameters()])
    assert _rel_l2(got, want) <= GRAD_TOL[dtype]


def _grads_with(gather, tcfg, params, nf, tt):
    model = tg.GraphSAGE(dataclasses.replace(tcfg, gather_fn=gather), num_nodes=N, in_dim=D)
    tg.load_flax_params(model, params)
    out = model(torch.from_numpy(nf), tt)
    cot = torch.from_numpy(np.random.default_rng(8).normal(size=tuple(out.shape)).astype(np.float32))
    grads = torch.autograd.grad((out * cot).sum(), list(model.parameters()))
    return out.detach(), np.concatenate([g.double().numpy().reshape(-1) for g in grads])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_index_k3_and_transpose_gathers_agree(graph, dtype):
    nf, jt, tt, *_ = graph
    jcfg, tcfg = _configs(dtype)
    params = _sage_params(jcfg, nf, jt)
    idx = tt.indices.numpy()
    gathers = {
        "k3": make_neighbor_gather(idx, N, edge_block=128, device="cpu"),
        "transpose": make_transpose_gather(idx, tt.mask.numpy(), N, device="cpu"),
    }
    out0, g0 = _grads_with(None, tcfg, params, nf, tt)
    for name, gather in gathers.items():
        out, g = _grads_with(gather, tcfg, params, nf, tt)
        assert torch.equal(out, out0), name
        if name == "k3" and dtype == "f32":
            continue  # K3's backward rounds its cotangent to bf16 (exact=False)
        assert _rel_l2(g, g0) <= GATHER_TOL[dtype], name


def test_a_gather_of_another_snapshot_is_refused(graph):
    nf, jt, tt, *_ = graph
    _, tcfg = _configs("f32")
    rng = np.random.default_rng(3)
    small = tg.build_neighbor_table(N, rng.integers(0, N, 99), rng.integers(0, N, 99),
                                    max_neighbors=K - 2)
    bad = make_transpose_gather(small.indices, small.mask, N, device="cpu")
    model = tg.GraphSAGE(dataclasses.replace(tcfg, gather_fn=bad), num_nodes=N, in_dim=D)
    with pytest.raises(ValueError, match="does not match"):
        model(torch.from_numpy(nf), tt)


def _edge_init(jcfg, nf, jt):
    """flax's edge-model init, as the JAX trainer makes it for the seed."""
    init_rng, _ = jax.random.split(jax.random.PRNGKey(CFG["seed"]))
    z = jnp.zeros((B,), jnp.int32)
    return _np(_JaxSAGEEdge(jcfg).init(init_rng, jnp.asarray(nf), jt, z, z)["params"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_edge_model_forward_matches_flax(graph, dtype):
    nf, jt, tt, src, dst, _ = graph
    jcfg, tcfg = _configs(dtype)
    params = _edge_init(jcfg, nf, jt)
    model = tg.load_flax_params(ttr._SAGEEdgeModel(tcfg, num_nodes=N, in_dim=D), params)
    want = _JaxSAGEEdge(jcfg).apply({"params": params}, jnp.asarray(nf), jt,
                                    jnp.asarray(src[:64]), jnp.asarray(dst[:64]))
    with torch.no_grad():
        got = model(torch.from_numpy(nf), tt, torch.from_numpy(src[:64]),
                    torch.from_numpy(dst[:64]))
    assert got.shape == (64,) and got.dtype == torch.float32
    _close(got.numpy(), want, dtype)
    with pytest.raises(ValueError):
        model(torch.from_numpy(nf), tt, torch.from_numpy(src[:4]), torch.from_numpy(dst[:4]),
              torch.zeros((4, 2)))


def test_warm_start_shifts_the_same_leaf_as_the_jax_package(graph):
    nf, jt, tt, *_ = graph
    jcfg, tcfg = _configs("bf16")
    params = _edge_init(jcfg, nf, jt)
    want = _flat(_np(jax_warm_start(params, 7.25)))
    model = tg.load_flax_params(ttr._SAGEEdgeModel(tcfg, num_nodes=N, in_dim=D), params)
    warm_start_output_bias(model, 7.25)
    got = _flat(tg.to_flax_params(model))
    changed = [k for k in want if not np.array_equal(want[k], _flat(params)[k])]
    assert changed == ["Dense_1/bias"]
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _jax_run(graph, dtype):
    nf, jt, tt, src, dst, y = graph
    jcfg, _ = _configs(dtype)
    jstate, jmet, jhist = jtr.train_graphsage(
        nf, jt, src, dst, y, model_config=jcfg, config=jtr.TrainConfig(**CFG), batch_size=B)
    _, train_idx = ttr.split_edges(E, CFG["seed"])
    return dict(dtype=dtype, p0=_edge_init(jcfg, nf, jt), target_mean=float(y[train_idx].mean()),
                jstate=jstate, jmet=jmet, jhist=jhist)


def _port_run(graph, jax_run, fault=None):
    """The port's loop from the same init, optionally with a planted fault."""
    nf, jt, tt, src, dst, y = graph
    _, tcfg = _configs(jax_run["dtype"])
    model = tg.load_flax_params(ttr._SAGEEdgeModel(tcfg, num_nodes=N, in_dim=D), jax_run["p0"])
    if fault == "unmasked_mean":
        tt = tg.NeighborTable(tt.indices, torch.ones_like(tt.mask), tt.edge_feats)
    update = ttr.AdamW.update
    if fault == "frozen_aggregate":
        frozen_p = model.GraphSAGE_0.SAGELayer_0.Dense_1.kernel

        def frozen(self, grads):
            grads = [torch.zeros_like(g) if p is frozen_p else g
                     for p, g in zip(self.params, grads)]
            return update(self, grads)

        ttr.AdamW.update = frozen
    try:
        tstate, tmet, thist = ttr._train_graph_model(
            model, nf, tt, src, dst, y, None, ttr.TrainConfig(**CFG), "cpu", B)
    finally:
        ttr.AdamW.update = update
    return dict(jax_run, tstate=tstate, tmet=tmet, thist=thist)


@pytest.fixture(scope="module", params=["bf16", "f32"])
def jax_run(request, graph):
    return _jax_run(graph, request.param)


@pytest.fixture(scope="module")
def runs(graph, jax_run):
    return jax_run["dtype"], _port_run(graph, jax_run)


def _moves(r):
    """Per leaf, ‖port − jax‖ / ‖jax − start‖ after training."""
    start = _flat(r["p0"])
    # Both trainers warm-start the output bias before their first step.
    start["Dense_1/bias"] = start["Dense_1/bias"] + r["target_mean"]
    jp = _flat(_np(r["jstate"].params))
    tp = _flat(tg.to_flax_params(r["tstate"].model))
    return {k: float(np.linalg.norm(tp[k] - jp[k]) / max(np.linalg.norm(jp[k] - start[k]), 1e-12))
            for k in jp}


def test_train_losses_match_jax(runs):
    dtype, r = runs
    jl = np.array([h["loss"] for h in r["jhist"]])
    tl = np.array([h["loss"] for h in r["thist"]])
    assert len(jl) == len(tl) == 2 * ((E - E // 10) // B) == 6
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL[dtype])
    jm, tm = r["jmet"].to_dict(), r["tmet"].to_dict()
    assert abs(tm["mae"] - jm["mae"]) <= 0.05 * jm["mae"]


def test_trained_weights_move_as_jax(runs):
    dtype, r = runs
    moves = _moves(r)
    assert len(moves) == 1 + 2 * 6 + 2 + 4
    assert max(moves.values()) <= MOVE_TOL[dtype], moves


@pytest.mark.parametrize("fault", ["frozen_aggregate", "unmasked_mean"])
def test_a_planted_fault_fails_the_weight_check(graph, jax_run, fault):
    r = _port_run(graph, jax_run, fault=fault)
    assert max(_moves(r).values()) > 2 * MOVE_TOL[jax_run["dtype"]]


def test_train_graphsage_learns_rtt():
    """As the JAX package's ``test_graphsage_learns_rtt`` (64 hosts), in 150
    epochs where it takes 300."""
    cluster = SyntheticCluster(num_hosts=64, seed=0)
    src, dst, rtt = cluster.probe_edges(density=0.3, seed=1)
    table = tg.build_neighbor_table(cluster.num_hosts, src, dst, rtt / 1e9)
    nf = cluster._host_feature_matrix()
    target = np.log1p(rtt / 1e6).astype(np.float32)  # log-ms
    state, metrics, history = ttr.train_graphsage(
        nf, table, src, dst, target,
        model_config=tg.GNNConfig(hidden=32, out_dim=16, num_layers=2, dropout=0.0),
        config=ttr.TrainConfig(epochs=150, learning_rate=1e-2, warmup_steps=20, log_every=100),
        device="cpu", batch_size=128,
    )
    assert isinstance(state.model, ttr._SAGEEdgeModel)
    assert history[0]["loss"] > history[-1]["loss"]
    baseline_mae = float(np.mean(np.abs(target - target.mean())))
    assert metrics.mae < baseline_mae * 0.5, (metrics.mae, baseline_mae)


def _swarm_probe_graph(hosts=1000, rounds=8, seed=0):
    """configs[1]'s probe graph from the port's swarm simulator (probe
    rounds only), as the JAX package's readings of ``train_graphsage``
    were taken."""
    import random
    import tempfile

    from dragonfly2_tpu_torch.records.storage import Storage
    from dragonfly2_tpu_torch.sim import SwarmConfig, SwarmSimulator

    sim = SwarmSimulator(Storage(tempfile.mkdtemp()), config=SwarmConfig(num_hosts=hosts, seed=seed),
                         rng=random.Random(seed))
    sim.run_probe_rounds(rounds)
    ids, src, dst, rtt = sim.topology.to_edge_arrays()
    nf = sim.cluster._host_feature_matrix()[np.array([sim._host_index[h] for h in ids])]
    return len(ids), nf, src, dst, rtt


def seed_study(jax_seeds=(0, 1, 2, 3, 4), port_seeds=tuple(range(8))):
    """Full width on the CPU (``GNNConfig()``, 1,000 nodes, K 16, batch
    4,096, 30 epochs, lr 3e-3, warm-up 20): the validation MAE of
    ``train_graphsage`` for several seeds in each package, and of one run
    from flax's seed-0 init carried into the port with dropout 0 in both.
    Prints JSON lines.  Run as ``python tests/test_torch_graphsage.py``."""
    import json

    n, nf, src, dst, rtt = _swarm_probe_graph()
    y = np.log1p(rtt / 1e6).astype(np.float32)
    val_idx, train_idx = ttr.split_edges(len(y), 0)
    print(json.dumps({"nodes": n, "edges": int(len(src)), "mean_predictor_mae": float(
        np.mean(np.abs(y[val_idx] - y[train_idx].mean())))}), flush=True)
    jt = jg.build_neighbor_table(n, src, dst, rtt / 1e9, max_neighbors=16)
    tt = tg.build_neighbor_table(n, src, dst, rtt / 1e9, max_neighbors=16)
    cfg = dict(epochs=30, learning_rate=3e-3, warmup_steps=20, log_every=8)
    for seed in jax_seeds:
        _, m, _ = jtr.train_graphsage(nf, jt, src, dst, y, model_config=jg.GNNConfig(),
                                      config=jtr.TrainConfig(seed=seed, **cfg), batch_size=4096)
        print(json.dumps({"package": "jax", "seed": seed, "val_mae": m.mae}), flush=True)
    for seed in port_seeds:
        _, m, _ = ttr.train_graphsage(nf, tt, src, dst, y, model_config=tg.GNNConfig(),
                                      config=ttr.TrainConfig(seed=seed, **cfg), device="cpu",
                                      batch_size=4096)
        print(json.dumps({"package": "port", "seed": seed, "val_mae": m.mae}), flush=True)
    jcfg, tcfg = jg.GNNConfig(dropout=0.0), tg.GNNConfig(dropout=0.0)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    z = jnp.zeros((4096,), jnp.int32)
    p0 = _np(_JaxSAGEEdge(jcfg).init(init_rng, jnp.asarray(nf), jt, z, z)["params"])
    _, jm, jh = jtr.train_graphsage(nf, jt, src, dst, y, model_config=jcfg,
                                    config=jtr.TrainConfig(seed=0, **cfg), batch_size=4096)
    model = tg.load_flax_params(ttr._SAGEEdgeModel(tcfg, num_nodes=n, in_dim=nf.shape[1]), p0)
    _, tm, th = ttr._train_graph_model(model, nf, tt, src, dst, y, None,
                                       ttr.TrainConfig(seed=0, **cfg), "cpu", 4096)
    print(json.dumps({"carried_flax_init_dropout_0": {
        "jax_val_mae": jm.mae, "port_val_mae": tm.mae,
        "jax_losses": [h["loss"] for h in jh], "port_losses": [h["loss"] for h in th]}}),
        flush=True)


if __name__ == "__main__":
    seed_study()
