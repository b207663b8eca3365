"""Port parity: the data-parallel and node-sharded trainers,
``dragonfly2_tpu_torch/trainer/{train,ingest}.py`` with ``mesh=``, against
``dragonfly2_tpu/trainer/{train,ingest}.py`` on a mesh of the same shape.

The port runs as 4 spawned gloo ranks on the CPU, a (2 data × 2 model)
mesh (``parallel.dryrun.run_ranks``: one spawn for the module, a
``FileStore`` in a fresh temporary directory); the JAX package on a
(2 × 2) mesh over 4 of the 8 forced CPU devices.  Parity runs carry
flax's init into the port (``load_flax_params``; a node-sharded model,
sharded first, takes its block of the embedding) with dropout 0.  The rank bodies
import no JAX.

Tolerances, stated:
- losses per step: 5e-3 (bf16) and 1e-4 (float32) relative, as
  ``tests/test_torch_hop.py``;
- trained weights, per leaf: ``‖port − jax‖ / ‖jax − start‖``, the
  relative L2 of the two trainers' moves from the common (warm-started)
  start, within 3.4e-2 (bf16: the one-device flagship's reading in
  ``tests/test_torch_hop.py``) and 4e-5 (float32: the one-device
  flagship's limit), but 1e-4 for one float32 leaf, the flagship's scalar
  output bias ``Dense_2/bias``: it reads 4.3e-5 on the mesh (its gradient
  is summed over 4 ranks in another order than XLA's), and 1e-4 is the
  float32 limit of ``tests/test_torch_train_mlp.py``.  Measured: 7.7e-6
  (MLP), 1.7e-5 (GAT), 1.7e-5 (flagship, both modes, every other leaf),
  2.2e-2 (flagship node-sharded, bf16).  The GAT's key-projection and edge-bias biases have a
  zero gradient in exact arithmetic (the softmax cancels a constant on
  every logit), so both packages move them by Adam's reading of rounding
  noise: they are held, as ``tests/test_torch_train_gat.py`` holds every
  GAT leaf, to 3 × the sum of the run's learning rates, absolute;
- two planted faults in the port's float32 node-sharded run must read
  above twice the float32 limit against the port's own run without the
  fault: gradients summed over the ranks, not averaged, and the sharded
  embedding counted once per model rank in the clip's norm.  Both change
  only what the clip sees (Adam's step does not see a gradient's
  constant scale), so these runs make the clip bite and the embedding
  weigh in its norm: the output bias starts at 0, ~14 log-units under
  the targets (no warm start), and the embedding is stored 50 times
  smaller behind a first kernel 50 times larger on its rows (the same
  function; its gradient's share of the norm goes from ~0.3 % to ~1-6 ×
  the rest).  Measured: 1.0e-3 (summed) and 1.3e-3 (norm), both on the
  encoder's first kernel;
- dropout 0.1 on the mesh against the port's one-device run from the
  same start: the MLP and the node-sharded flagship drop per batch row,
  and each data rank keeps its rows of the global batch's mask
  (``models.gnn.BatchRowsDraw``), so the two runs draw the same masks and
  are held to the float32 loss and leaf-move limits above.  Were two
  data ranks to draw equal masks, the runs would part by the dropout
  noise itself;
- the port's node-sharded run against its replicated run at the JAX
  test's shape (``tests/test_trainer.py``): validation MAE within 5e-3;
- ``multihost=True``: the same files, and rows, as the JAX package's
  ``shard_for_process(paths, rank, 4)``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.models import hop as th
from dragonfly2_tpu_torch.models import mlp as tm
from dragonfly2_tpu_torch.models.mlp import warm_start_output_bias
from dragonfly2_tpu_torch.parallel import graph_sharding as tgs
from dragonfly2_tpu_torch.parallel import mesh as tpm
from dragonfly2_tpu_torch.parallel.dryrun import run_ranks
from dragonfly2_tpu_torch.records.columnar import ColumnarWriter
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, DOWNLOAD_FEATURE_DIM
from dragonfly2_tpu_torch.trainer import ingest as ting
from dragonfly2_tpu_torch.trainer import train as ttr

LOSS_RTOL = {"bf16": 5e-3, "f32": 1e-4}
MOVE_TOL = {"bf16": 3.4e-2, "f32": 4e-5}
# The flagship's scalar output bias in float32 (module docstring).
OUTPUT_BIAS_TOL = 1e-4
TDTYPE = {"bf16": torch.bfloat16, "f32": torch.float32}
MLP_CFG = dict(learning_rate=3e-3, weight_decay=0.1, epochs=3, warmup_steps=2, log_every=1,
               seed=3)
GRAPH_CFG = dict(learning_rate=3e-3, weight_decay=0.1, epochs=2, warmup_steps=1, log_every=1,
                 seed=5)
N, K, D, B, M = 96, 6, 12, 32, 240
GAT_KW = dict(hidden=16, out_dim=8, num_layers=2, num_heads=2, node_embed_dim=8, dropout=0.0)
HOP_KW = dict(hidden=32, out_dim=16, node_embed_dim=8, dropout=0.0)
# The fault runs store the embedding this many times smaller (module docstring).
FAULT_EMBED_SCALE = 50.0
CASES = ["mlp-f32", "gat-f32", "hop_replicated-f32", "hop_model-f32", "hop_model-bf16"]
FAULTS = ["summed_gradients", "norm_counts_shard_per_rank"]
# Run with dropout on the mesh and on one device (module docstring).
DROPOUT = 0.1
DROPOUT_CASES = ["mlp-f32", "hop_model-f32"]


def _rows(n, seed=0):
    """Download rows with a learnable target and one constant column."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, len(DOWNLOAD_COLUMNS)), np.float32)
    rows[:, 0] = rng.integers(0, 1 << 20, n)
    rows[:, 1] = rng.integers(0, 1 << 20, n)
    feats = (rng.standard_normal((n, DOWNLOAD_FEATURE_DIM)) * 2.0 + 1.0).astype(np.float32)
    feats[:, 7] = 3.0
    rows[:, 2:2 + DOWNLOAD_FEATURE_DIM] = feats
    w = rng.standard_normal(DOWNLOAD_FEATURE_DIM).astype(np.float32) * 0.2
    rows[:, -1] = 13.0 + feats @ w + rng.standard_normal(n).astype(np.float32) * 0.1
    return rows


def _graph(seed=1):
    """tests/test_torch_hop.py's probe graph and download edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 300)
    dst = rng.integers(0, N - 8, 300)
    rtt = rng.random(300).astype(np.float32) * 2.0
    nf = rng.normal(size=(N, D)).astype(np.float32)
    es = rng.integers(0, N, M)
    ed = (es + rng.integers(1, N, M)) % N
    y = (rng.normal(size=M) * 0.5 + 14.0).astype(np.float32)
    return dict(nf=nf, src=src, dst=dst, rtt=rtt, es=es, ed=ed, y=y)


def _model_parallel_graph():
    """tests/test_trainer.py's node-sharded-against-replicated shape."""
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster

    n_nodes, n_edges = 512, 16_384
    cluster = SyntheticCluster(num_hosts=n_nodes, seed=0)
    src, dst, rtt = cluster.probe_edges(density=0.05, seed=0)
    rng = np.random.default_rng(0)
    es = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    ed = (es + rng.integers(1, n_nodes, n_edges).astype(np.int32)) % n_nodes
    y = np.log1p(cluster._bandwidth_vec(es, ed, rng=np.random.default_rng(7))).astype(np.float32)
    return dict(n=n_nodes, nf=cluster._host_feature_matrix(), src=src, dst=dst, rtt=rtt / 1e9,
                es=es, ed=ed, y=y)


def _mlp_data(mod):
    rows = _rows(1200, seed=5)
    return (mod.EdgeBatches(rows[200:], batch_size=128, seed=1),
            mod.EdgeBatches(rows[:200], batch_size=128, shuffle=False, drop_remainder=False))


def _table(g):
    return tg.build_neighbor_table(N, g["src"], g["dst"], g["rtt"], max_neighbors=K)


def _port_model(case, p0, g, mesh=None, dropout=0.0):
    """The port's model from flax's init; with ``mesh``, a node-sharded
    flagship takes its block of the embedding from the whole table."""
    kind, dtype = case.split("-")
    td = TDTYPE[dtype]
    if kind == "mlp":
        return tg.load_flax_params(tm.MLPRegressor(tm.MLPConfig(
            hidden=(64, 32), dropout=dropout, dtype=td)), p0)
    if kind == "gat":
        return tg.load_flax_params(tg.GATRanker(tg.GNNConfig(dtype=td, **GAT_KW), num_nodes=N,
                                                in_dim=D), p0)
    model = th.HopRanker(th.HopConfig(dtype=td, **{**HOP_KW, "dropout": dropout}), num_nodes=N,
                         in_dim=th.hop_feature_dim(D, 2))
    if kind == "hop_model" and mesh is not None:
        model.shard_nodes(tgs.NodeShard(mesh, tpm.MODEL_AXIS, N))
        assert model.HopEncoder_0.Embed_0.embedding.shape[0] == N // 2
    return tg.load_flax_params(model, p0)


def _summed_gradients(self, flat, group, n):
    return tpm.all_reduce(flat, group)


def _norm_counts_shard_per_rank(self, repl_sq, shard_sq):
    return repl_sq + self.mesh.shape[tpm.MODEL_AXIS] * tpm.all_reduce(
        shard_sq, self.mesh.group(tpm.MODEL_AXIS))


def _fault_start(p0):
    """The fault runs' start: flax's init with the embedding stored
    FAULT_EMBED_SCALE times smaller behind first-kernel rows that much
    larger (the same function)."""
    p = {k: dict(v) if isinstance(v, dict) else v for k, v in p0.items()}
    enc = {k: dict(v) for k, v in p["HopEncoder_0"].items()}
    enc["Embed_0"]["embedding"] = enc["Embed_0"]["embedding"] / FAULT_EMBED_SCALE
    kernel = enc["Dense_0"]["kernel"].copy()
    kernel[th.hop_feature_dim(D, 2):] *= FAULT_EMBED_SCALE
    enc["Dense_0"]["kernel"] = kernel
    p["HopEncoder_0"] = enc
    return p


def _whole_params(state):
    return {k: v.numpy().astype(np.float64) for k, v in ttr.full_params(state).items()}


def _run_case(mesh, case, p0, g, dropout=0.0):
    """One port run from flax's init, on the mesh or (``mesh=None``) on
    one device → (losses, mae, whole params)."""
    kind, _ = case.split("-")
    model = _port_model(case, p0, g, mesh, dropout)
    if kind == "mlp":
        state, met, hist = ttr._train_mlp_model(
            model, *_mlp_data(ting), ttr.TrainConfig(**MLP_CFG), "cpu", mesh)
    else:
        table = _table(g)
        nf, mode = g["nf"], "replicated"
        if kind == "hop_model" and mesh is not None:
            mode = "model"
            plan = tgs.build_halo_plan(table, mesh, axis=tpm.MODEL_AXIS)
            nf = tgs.precompute_hop_features_sharded(mesh, nf, table, plan, hops=2,
                                                     axis=tpm.MODEL_AXIS)
        elif kind.startswith("hop"):
            nf = th.precompute_hop_features(torch.from_numpy(nf), table, hops=2)
        state, met, hist = ttr._train_graph_model(
            model, nf, table, g["es"], g["ed"], g["y"], None, ttr.TrainConfig(**GRAPH_CFG),
            "cpu", B, mesh=mesh, node_sharding=mode)
    return dict(losses=[h["loss"] for h in hist], mae=met.mae, params=_whole_params(state))


def _fault_run(mesh, p0, g, fault):
    """The float32 node-sharded run from ``_fault_start`` with the output
    bias left cold, with ``fault`` planted (None: none) → whole params."""
    model = _port_model("hop_model-f32", _fault_start(p0), g, mesh)
    table = _table(g)
    plan = tgs.build_halo_plan(table, mesh, axis=tpm.MODEL_AXIS)
    nf = tgs.precompute_hop_features_sharded(mesh, g["nf"], table, plan, hops=2,
                                             axis=tpm.MODEL_AXIS)
    saved = (ttr._MeshSync.reduce_mean, ttr._MeshSync.norm_sq, ttr.warm_start_output_bias)
    if fault == "summed_gradients":
        ttr._MeshSync.reduce_mean = _summed_gradients
    elif fault == "norm_counts_shard_per_rank":
        ttr._MeshSync.norm_sq = _norm_counts_shard_per_rank
    ttr.warm_start_output_bias = lambda model, value: model
    try:
        state, _, _ = ttr._train_graph_model(
            model, nf, table, g["es"], g["ed"], g["y"], None, ttr.TrainConfig(**GRAPH_CFG),
            "cpu", B, mesh=mesh, node_sharding="model")
    finally:
        ttr._MeshSync.reduce_mean, ttr._MeshSync.norm_sq, ttr.warm_start_output_bias = saved
    return _whole_params(state)


def _wait_for_inits(hand: str, timeout: float = 600.0):
    """flax's inits, once the test process has written them into ``hand``."""
    import time

    t0 = time.monotonic()
    while not os.path.exists(os.path.join(hand, "p0.pt")):
        if os.path.exists(os.path.join(hand, "failed")):
            raise RuntimeError("the JAX side failed: no inits to carry")
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no inits in {hand} after {timeout} s")
        time.sleep(0.05)
    return torch.load(os.path.join(hand, "p0.pt"), weights_only=False)


def _rank_body(rank, dev, hand, paths):
    mesh = tpm.create_mesh(tpm.MeshSpec(data=2, model=2), device=dev)
    p0s = _wait_for_inits(hand)
    g = _graph()
    out = {"cases": {c: _run_case(mesh, c, p0s[c], g) for c in CASES}}
    out["dropout"] = {c: _run_case(mesh, c, p0s[c], g, DROPOUT) for c in DROPOUT_CASES}
    out["faults"] = {f: _fault_run(mesh, p0s["hop_model-f32"], g, f) for f in [None, *FAULTS]}
    # The port's node-sharded run against its replicated run.
    mp = _model_parallel_graph()
    table = tg.build_neighbor_table(mp["n"], mp["src"], mp["dst"], mp["rtt"], max_neighbors=8)
    kw = dict(model_config=th.HopConfig(hidden=32, out_dim=16, node_embed_dim=8),
              config=ttr.TrainConfig(epochs=2, warmup_steps=2), batch_size=2048, mesh=mesh)
    out["mp"] = {}
    for mode in ("replicated", "model"):
        state, met, _ = ttr.train_hop_ranker(mp["nf"], table, mp["es"], mp["ed"], mp["y"],
                                             node_sharding=mode, **kw)
        out["mp"][mode] = met.mae
    # Every rank reads the node-sharded checkpoint back as soon as
    # save_checkpoint returns.
    path = os.path.join(hand, "mesh_ckpt.pt")
    ttr.save_checkpoint(path, state)
    back = _flat(ttr.restore_params(path))
    saved = _whole_params(state)
    out["ckpt_read_back"] = sorted(back) == sorted(saved) and all(
        np.array_equal(back[k], saved[k]) for k in saved)
    # Same seed, same table: the sharded embedding holds the unsharded rows.
    whole = th.HopRanker(th.HopConfig(**HOP_KW), num_nodes=N, in_dim=D,
                         generator=torch.Generator().manual_seed(7))
    block = th.HopRanker(th.HopConfig(**HOP_KW), num_nodes=N, in_dim=D,
                         generator=torch.Generator().manual_seed(7)).shard_nodes(
        tgs.NodeShard(mesh, tpm.MODEL_AXIS, N))
    c = mesh.coord(tpm.MODEL_AXIS)
    out["embed_block_equal"] = torch.equal(
        block.HopEncoder_0.Embed_0.embedding,
        whole.HopEncoder_0.Embed_0.embedding[c * N // 2:(c + 1) * N // 2])
    # Refusals on a mesh.
    small = tg.build_neighbor_table(5, np.arange(4), np.arange(1, 5), max_neighbors=2)
    try:
        ttr.train_hop_ranker(np.zeros((5, 4), np.float32), small, np.arange(4), np.arange(4),
                             np.zeros(4, np.float32), node_sharding="model", mesh=mesh)
        out["indivisible"] = "accepted"
    except ValueError as e:
        out["indivisible"] = str(e)
    train, _ = ting.load_download_dataset(paths, batch_size=64, seed=2, multihost=True)
    out["multihost"] = {"files": ting.shard_for_process(paths), "rows": train.rows,
                        "rank": rank}
    return out


# ---------------------------------------------------------------------------
# The JAX side (the test process)
# ---------------------------------------------------------------------------


def _jax_mesh():
    import jax

    from dragonfly2_tpu.parallel.mesh import MeshSpec, create_mesh

    return create_mesh(MeshSpec(data=2, model=2), devices=jax.devices()[:4])


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_runs():
    """Each case's JAX trainer run on the (2 × 2) mesh, and flax's init as
    that trainer made it (read where it warm-starts the output bias)."""
    import jax.numpy as jnp

    from dragonfly2_tpu.models import gnn as jg
    from dragonfly2_tpu.models import hop as jh
    from dragonfly2_tpu.models import mlp as jm
    from dragonfly2_tpu.trainer import ingest as jing
    from dragonfly2_tpu.trainer import train as jtr

    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    mesh = _jax_mesh()
    g = _graph()
    jt = jg.build_neighbor_table(N, g["src"], g["dst"], g["rtt"], max_neighbors=K)
    hop = np.asarray(jh.precompute_hop_features(jnp.asarray(g["nf"]), jt, hops=2))
    inits = []
    warm = jm.warm_start_output_bias

    def keep_init(params, value):
        inits.append(_np(params))
        return warm(params, value)

    out = {}
    jm.warm_start_output_bias = keep_init
    try:
        for case in CASES:
            kind, dtype = case.split("-")
            if kind == "mlp":
                state, met, hist = jtr.train_mlp(
                    *_mlp_data(jing), config=jtr.TrainConfig(**MLP_CFG), mesh=mesh,
                    model_config=jm.MLPConfig(hidden=(64, 32), dropout=0.0, dtype=jdt[dtype]))
            elif kind == "gat":
                state, met, hist = jtr.train_gat_ranker(
                    g["nf"], jt, g["es"], g["ed"], g["y"], config=jtr.TrainConfig(**GRAPH_CFG),
                    mesh=mesh, batch_size=B,
                    model_config=jg.GNNConfig(dtype=jdt[dtype], **GAT_KW))
            else:
                state, met, hist = jtr.train_hop_ranker(
                    g["nf"], jt, g["es"], g["ed"], g["y"], config=jtr.TrainConfig(**GRAPH_CFG),
                    mesh=mesh, batch_size=B, hop_feats=hop,
                    node_sharding="model" if kind == "hop_model" else "replicated",
                    model_config=jh.HopConfig(dtype=jdt[dtype], **HOP_KW))
            out[case] = dict(p0=inits.pop(), losses=[h["loss"] for h in hist], mae=met.mae,
                             params=_flat(_np(state.params)))
    finally:
        jm.warm_start_output_bias = warm
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v, np.float64)})
    return out


@pytest.fixture(scope="module")
def shard_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    paths = []
    for i in range(6):
        p = str(d / f"download_{i}.dfc")
        with ColumnarWriter(p, DOWNLOAD_COLUMNS) as w:
            w.append(_rows(100 + 30 * i, seed=10 + i))
        paths.append(p)
    return paths[::-1]


@pytest.fixture(scope="module")
def both(shard_paths, tmp_path_factory):
    """(the port's ranks, the JAX runs).  The ranks start first and wait
    for flax's inits, which the JAX runs hand over through a file."""
    import threading

    hand = tmp_path_factory.mktemp("inits")
    got = {}

    def spawn():
        try:
            got["ranks"] = run_ranks(_rank_body, 4, device="cpu", args=(str(hand), shard_paths))
        except BaseException as e:  # re-raised below, in the test's thread
            got["error"] = e

    worker = threading.Thread(target=spawn)
    worker.start()
    try:
        jax_runs = _jax_runs()
        torch.save({c: r["p0"] for c, r in jax_runs.items()}, str(hand / "p0.tmp"))
        os.replace(hand / "p0.tmp", hand / "p0.pt")
    except BaseException:
        (hand / "failed").touch()
        raise
    finally:
        worker.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], jax_runs


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_runs(both):
    return both[1]


def _start(case, p0, y_mean):
    """The common start: flax's init with the output bias warm-started."""
    model = _port_model(case, p0, None)
    warm_start_output_bias(model, y_mean)
    return _flat(tg.to_flax_params(model))


def _moves(case, p0, port, jax_params, y_mean):
    start = _start(case, p0, y_mean)
    assert sorted(port) == sorted(jax_params) == sorted(start)
    return {k: float(np.linalg.norm(port[k] - jax_params[k])
                     / max(np.linalg.norm(jax_params[k] - start[k]), 1e-12)) for k in start}


def _train_mean(case):
    if case.startswith("mlp"):
        return float(_mlp_data(ting)[0].rows[:, -1].mean())
    g = _graph()
    _, train_idx = ttr.split_edges(M, GRAPH_CFG["seed"])
    return float(g["y"][train_idx].mean())


@pytest.mark.parametrize("case", CASES)
def test_losses_match_jax_on_the_mesh(ranks, jax_runs, case):
    dtype = case.split("-")[1]
    jl = np.array(jax_runs[case]["losses"])
    for r in ranks:
        tl = np.array(r["cases"][case]["losses"])
        assert len(tl) == len(jl) > 0
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL[dtype])
        assert tl.tolist() == ranks[0]["cases"][case]["losses"]


def _shift_invariant(case, leaf):
    """The GAT's key-projection and edge-bias biases: a constant on every
    neighbor's logit, which the softmax cancels, so their gradient is
    zero in exact arithmetic and both packages move them by Adam's
    reading of rounding noise alone."""
    parts = leaf.split("/")
    return case.startswith("gat") and parts[0].startswith("GATLayer_") and \
        parts[1:] in (["Dense_1", "bias"], ["Dense_3", "bias"])


def _move_tol(case, leaf):
    dtype = case.split("-")[1]
    if dtype == "f32" and case.startswith("hop") and leaf == "Dense_2/bias":
        return OUTPUT_BIAS_TOL
    return MOVE_TOL[dtype]


def _lr_sum(steps):
    cfg = ttr.TrainConfig(**GRAPH_CFG)
    schedule = ttr.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, cfg.warmup_steps,
                                                max(steps, cfg.warmup_steps + 1))
    return sum(schedule(i) for i in range(steps))


@pytest.mark.parametrize("case", CASES)
def test_trained_leaves_move_as_jax_on_the_mesh(ranks, jax_runs, case):
    j = jax_runs[case]
    port = ranks[0]["cases"][case]["params"]
    moves = _moves(case, j["p0"], port, j["params"], _train_mean(case))
    held = {k: v for k, v in moves.items() if not _shift_invariant(case, k)}
    assert all(v <= _move_tol(case, k) for k, v in held.items()), held
    # The shift-invariant leaves: tests/test_torch_train_gat.py's bound,
    # 3 x the sum of the run's learning rates, absolute.
    for k in set(moves) - set(held):
        bound = 3 * _lr_sum(len(j["losses"]))
        assert np.max(np.abs(port[k] - j["params"][k])) <= bound, k
    assert len(held) >= len(moves) - 4
    for r in ranks[1:]:
        for k, v in r["cases"][case]["params"].items():
            assert np.array_equal(v, ranks[0]["cases"][case]["params"][k]), (case, k)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails_the_weight_check(ranks, jax_runs, fault):
    """The faulty run against the port's run without it, from the same
    start: ``‖faulty − clean‖ / ‖clean − start‖`` per leaf."""
    clean, bad = ranks[0]["faults"][None], ranks[0]["faults"][fault]
    start = _flat(_fault_start(jax_runs["hop_model-f32"]["p0"]))
    moves = {k: float(np.linalg.norm(bad[k] - clean[k])
                      / max(np.linalg.norm(clean[k] - start[k]), 1e-12)) for k in clean}
    assert max(moves.values()) > 2 * MOVE_TOL["f32"], moves


@pytest.mark.parametrize("case", DROPOUT_CASES)
def test_dropout_on_the_mesh_draws_the_one_device_masks(ranks, jax_runs, case):
    """The mesh run with dropout against the port's one-device run from
    the same start: equal masks, so the float32 limits hold."""
    one = _run_case(None, case, jax_runs[case]["p0"], _graph(), DROPOUT)
    for r in ranks:
        got = r["dropout"][case]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL["f32"])
    mesh_params = ranks[0]["dropout"][case]["params"]
    start = _start(case, jax_runs[case]["p0"], _train_mean(case))
    moves = {k: float(np.linalg.norm(mesh_params[k] - one["params"][k])
                      / max(np.linalg.norm(one["params"][k] - start[k]), 1e-12))
             for k in start}
    assert all(v <= _move_tol(case, k) for k, v in moves.items()), moves


def test_data_ranks_keep_their_rows_of_one_mask():
    """``BatchRowsDraw``: two data ranks' draws differ, and stacked in
    data order they are one generator's draw of the global batch (here
    two stacked batches, as the hop encoder's source and destination
    rows)."""
    rows, width = 16, 8
    whole = torch.rand((2, 2 * rows, width), generator=torch.Generator().manual_seed(4))
    mine = [tg.BatchRowsDraw(torch.Generator().manual_seed(4), 2, d, rows).rand(
        (2 * rows, width), "cpu").view(2, rows, width) for d in range(2)]
    assert not torch.equal(mine[0], mine[1])
    assert torch.equal(torch.cat(mine, dim=1), whole)
    x = torch.ones(2 * rows, width)
    kept = [tg.dropout(x, 0.5, tg.BatchRowsDraw(torch.Generator().manual_seed(4), 2, d, rows))
            for d in range(2)]
    assert not torch.equal(kept[0], kept[1])
    with pytest.raises(ValueError, match="not a stack"):
        tg.BatchRowsDraw(torch.Generator(), 2, 0, rows).rand((rows + 1, width), "cpu")


def test_node_sharded_training_matches_replicated(ranks):
    for r in ranks:
        assert abs(r["mp"]["replicated"] - r["mp"]["model"]) < 5e-3, r["mp"]


def test_mesh_checkpoint_is_whole_when_save_returns(ranks):
    assert all(r["ckpt_read_back"] for r in ranks)


def test_multihost_opens_the_processes_shards(ranks, shard_paths):
    from dragonfly2_tpu.trainer import ingest as jing

    opened = set()
    for r in ranks:
        want = jing.shard_for_process(shard_paths, process_index=r["multihost"]["rank"],
                                      process_count=4)
        assert r["multihost"]["files"] == want
        jtrain, _ = jing.load_download_dataset(want, batch_size=64, seed=2)
        assert np.array_equal(r["multihost"]["rows"], jtrain.rows)
        opened.update(want)
    assert opened == set(shard_paths)


def test_bad_configs_refuse():
    g = _graph()
    table = _table(g)
    with pytest.raises(ValueError, match="needs a mesh"):
        ttr.train_hop_ranker(g["nf"], table, g["es"], g["ed"], g["y"], device="cpu",
                             node_sharding="model")
    with pytest.raises(ValueError, match="unknown node_sharding"):
        ttr.train_hop_ranker(g["nf"], table, g["es"], g["ed"], g["y"], device="cpu",
                             node_sharding="bogus")


def test_sharded_embedding_holds_the_unsharded_rows(ranks):
    assert all(r["embed_block_equal"] for r in ranks)


def test_indivisible_node_count_refuses_on_the_mesh(ranks):
    for r in ranks:
        assert "not divisible" in r["indivisible"]
