"""Port: the trainer service across ranks, ``dragonfly2_tpu_torch/trainer/
service.py`` with ``ranks=`` (``parallel/launch.RankGroup``) and
held against the port's one-device service on the same DFC1 shards (the
JAX service's registry rows and MAE:
``tests/test_torch_trainer_ranks_reference.py``; serve mode and the
binary: ``tests/test_torch_trainer_ranks_serve.py``).

The ranks are gloo groups on the CPU: this process is rank 0, the others
are spawned children that import this module (so it imports no JAX).
Batches are multiples of 4 (the MLP's 128 rows, the GNN's 256), so 1, 2
and 4 ranks train on the same global batches in the same order.

Tolerances, stated (those of ``tests/test_torch_multidevice_train.py``):
- trained weights, per leaf: ``‖ranks − one‖ / ‖one − start‖``, the
  relative L2 of the two runs' moves from the common start (the service
  at 0 epochs: the seeded init with the output bias warm-started).  The
  service's models compute in bfloat16, held at 3.4e-2; with every model
  config switched to float32 (in every rank), 4e-5, but for the GAT's
  node embedding, whose gradient arrives through the neighbor gather's
  backward (K3's plain version rounds its operands to bfloat16, as the
  kernel does): it reads 1.1e-3 and is held at the bfloat16 bound.  The GAT's
  key-projection and edge-bias biases have a zero gradient in exact
  arithmetic (the softmax cancels them), so both runs move them by Adam's
  reading of rounding noise: held to 3 × the run's summed learning
  rates, absolute.  Every rank holds the same bits (equal leaves, and
  equal ``TrainRun.leaf_digests``);
- losses at every logged step: 5e-3 (bfloat16) and 1e-4 (float32)
  relative;
- planted faults read above twice the limit: rank 1 takes the all-reduce
  but steps on its own gradients (its leaves leave the one-device run's),
  and rank 1 registers (two registrations of each model).

The trained leaves come back through test hooks: ``_keep`` also stores
them on the run, and ``summary`` adds them to what each rank reports
(installed in every rank: by ``rank_init`` in the helpers, by a fixture
in this process).
"""

from __future__ import annotations

import contextlib
import hashlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dragonfly2_tpu_torch.manager.registry import ModelRegistry
from dragonfly2_tpu_torch.parallel.launch import RankGroup, plan_ranks
from dragonfly2_tpu_torch.records.columnar import ColumnarWriter
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, TOPO_COLUMNS, topology_to_rows
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.trainer import metrics as trainer_metrics
from dragonfly2_tpu_torch.trainer import service as tsvc
from dragonfly2_tpu_torch.trainer import train as ttr

HOSTS, DOWNLOADS, TOPOLOGY = 256, 1024, 128
TRAIN = dict(epochs=3, learning_rate=3e-3, warmup_steps=5, log_every=1)
MOVE_TOL = {"bf16": 3.4e-2, "f32": 4e-5}
LOSS_RTOL = {"bf16": 5e-3, "f32": 1e-4}
MLP, GNN = tsvc.MLP_MODEL_NAME, tsvc.GNN_MODEL_NAME


def write_shards(directory, seed=0):
    os.makedirs(directory, exist_ok=True)
    cluster = SyntheticCluster(num_hosts=HOSTS, seed=seed)
    with ColumnarWriter(os.path.join(directory, "download_0.dfc"), DOWNLOAD_COLUMNS) as w:
        w.append(cluster.generate_feature_rows(DOWNLOADS, seed=seed))
    with ColumnarWriter(os.path.join(directory, "networktopology_0.dfc"), TOPO_COLUMNS) as w:
        for record in cluster.generate_topology_records(TOPOLOGY):
            w.append(topology_to_rows(record, now_ns=record.created_at))
    return directory


def train_round(svc, directory, **kw):
    session = svc.open_train_stream(ip="10.0.0.1", hostname="trainer-host", scheduler_id="s1")
    session.send_download_shard(os.path.join(directory, "download_0.dfc"))
    session.send_network_topology_shard(os.path.join(directory, "networktopology_0.dfc"))
    return svc.runs[session.close_and_train(**kw)]


def service(epochs=TRAIN["epochs"], **kw):
    cfg = ttr.TrainConfig(**{**TRAIN, "epochs": epochs})
    return tsvc.TrainerService(ModelRegistry(), train_config=cfg, gnn_model="gat", **kw)


# -- what the spawned ranks run (module level: the children import it) ----

_KEEP = tsvc.TrainerService._keep
_SUMMARY = tsvc.TrainerService.summary


def _keep_leaves(self, run, name, state, history):
    """``_keep``, and the trained parameters as numpy on ``run.leaves``."""
    _KEEP(self, run, name, state, history)
    leaves = {k: v.float().numpy() for k, v in ttr.full_params(state).items()}
    run.__dict__.setdefault("leaves", {})[name] = leaves


def _summary_with_leaves(self, run, registry_calls):
    return {**_SUMMARY(self, run, registry_calls), "leaves": run.__dict__.get("leaves", {})}


def _install_leaf_hooks():
    tsvc.TrainerService._keep = _keep_leaves
    tsvc.TrainerService.summary = _summary_with_leaves


def rank_leaves(rank):
    _install_leaf_hooks()


def _model_dtypes(dtype):
    """Set every model config's default compute dtype; → the old defaults."""
    from dragonfly2_tpu_torch.models import gnn, hop, mlp

    saved = []
    for cls in (mlp.MLPConfig, gnn.GNNConfig, hop.HopConfig):
        d = cls.__init__.__defaults__
        saved.append((cls, d))
        cls.__init__.__defaults__ = tuple(dtype if isinstance(v, torch.dtype) else v for v in d)
    return saved


@contextlib.contextmanager
def f32_models():
    """Every model config of the service computes in float32."""
    saved = _model_dtypes(torch.float32)
    try:
        yield
    finally:
        for cls, d in saved:
            cls.__init__.__defaults__ = d


def rank_f32(rank):
    _install_leaf_hooks()
    _model_dtypes(torch.float32)


def _local_average(self, loss, grads):
    """Takes the all-reduce, then steps on this rank's own gradients."""
    _ORIGINAL_AVERAGE(self, loss, grads)
    return loss, grads


_ORIGINAL_AVERAGE = ttr._MeshSync.average


def rank_faults(rank):
    _install_leaf_hooks()
    if rank == 1:
        ttr._MeshSync.average = _local_average
        tsvc.TrainerService._is_publisher = staticmethod(lambda mesh: True)


def _refuse(*args, **kwargs):
    raise ValueError("no full batches: 3 train edges < batch 4 (data axis 4)")


def rank_refuse_gnn(rank):
    _install_leaf_hooks()
    ttr.train_gat_ranker = _refuse


# -- fixtures -------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def leaf_hooks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsvc.TrainerService, "_keep", _keep_leaves)
        mp.setattr(tsvc.TrainerService, "summary", _summary_with_leaves)
        yield


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(str(tmp_path_factory.mktemp("shards")))


@pytest.fixture(scope="module")
def one(shards):
    return {"bf16": train_round(service(device="cpu"), shards),
            "start": train_round(service(0, device="cpu"), shards)}


@pytest.fixture(scope="module")
def one_f32(shards):
    with f32_models():
        return {"f32": train_round(service(device="cpu"), shards),
                "start": train_round(service(0, device="cpu"), shards)}


def _grouped(shards, n, rank_init=rank_leaves, f32=False):
    group = RankGroup(n, device="cpu", rank_init=rank_init)
    svc = service(ranks=group)
    try:
        with f32_models() if f32 else contextlib.nullcontext():
            return svc, train_round(svc, shards)
    finally:
        group.close()


@pytest.fixture(scope="module", params=[2, 4])
def ranked(request, shards):
    published = trainer_metrics.MODELS_PUBLISHED.value(model="gnn")
    svc, run = _grouped(shards, request.param)
    return {"n": request.param, "svc": svc, "run": run,
            "gnn_published": trainer_metrics.MODELS_PUBLISHED.value(model="gnn") - published}


# -- weight checks --------------------------------------------------------


def _shift_invariant(leaf):
    parts = leaf.split("/")
    return parts[0].startswith("GATLayer_") and parts[1:] in (["Dense_1", "bias"],
                                                              ["Dense_3", "bias"])


def _lr_sum(steps):
    cfg = ttr.TrainConfig(**TRAIN)
    schedule = ttr.warmup_cosine_decay_schedule(0.0, cfg.learning_rate, cfg.warmup_steps,
                                                max(steps, cfg.warmup_steps + 1))
    return sum(schedule(i) for i in range(steps))


def _moves(got, ref, start):
    return {k: float(np.linalg.norm(got[k] - ref[k])
                     / max(np.linalg.norm(ref[k] - start[k]), 1e-12)) for k in ref}


def _tol(dtype, name, leaf):
    if name == GNN and leaf == "NodeEmbedding_0/embedding":
        return MOVE_TOL["bf16"]
    return MOVE_TOL[dtype]


def _held(leaves, ref_run, start_run, dtype):
    for name in (MLP, GNN):
        moves = _moves(leaves[name], ref_run.leaves[name], start_run.leaves[name])
        held = {k: v for k, v in moves.items() if not _shift_invariant(k)}
        over = {k: v for k, v in held.items() if v > _tol(dtype, name, k)}
        assert held and not over, (name, over)
        steps = len(ref_run.history[name])
        for k in set(moves) - set(held):
            diff = np.max(np.abs(leaves[name][k] - ref_run.leaves[name][k]))
            assert diff <= 3 * _lr_sum(steps), (name, k, diff)


def test_every_rank_holds_the_one_device_leaves(ranked, one):
    run = ranked["run"]
    assert run.error is None and len(run.ranks) == ranked["n"]
    for r in run.ranks:
        _held(r["leaves"], one["bf16"], one["start"], "bf16")
        for name, leaves in r["leaves"].items():
            for k, v in leaves.items():
                assert np.array_equal(v, run.ranks[0]["leaves"][name][k]), (r["rank"], name, k)
        assert sorted(r["leaf_digests"]) == sorted([MLP, GNN])
        assert r["leaf_digests"] == run.ranks[0]["leaf_digests"] == run.leaf_digests
        for name, leaves in r["leaves"].items():
            assert r["leaf_digests"][name] == {
                k: hashlib.sha256(np.ascontiguousarray(v, np.float32).tobytes()).hexdigest()
                for k, v in leaves.items()}, name


def test_losses_match_the_one_device_run_at_every_logged_step(ranked, one):
    for r in ranked["run"].ranks:
        for name in (MLP, GNN):
            got = [h["loss"] for h in r["history"][name]]
            want = [h["loss"] for h in one["bf16"].history[name]]
            assert len(got) == len(want) > 0
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL["bf16"])


def test_float32_leaves_hold_4e_5(shards, one_f32):
    _, run = _grouped(shards, 2, rank_init=rank_f32, f32=True)
    assert run.error is None
    for r in run.ranks:
        _held(r["leaves"], one_f32["f32"], one_f32["start"], "f32")
        for name in (MLP, GNN):
            got = [h["loss"] for h in r["history"][name]]
            want = [h["loss"] for h in one_f32["f32"].history[name]]
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL["f32"])


def test_rank0_alone_registers_and_every_rank_carries_the_same_metrics(ranked, one):
    svc, run = ranked["svc"], ranked["run"]
    rows = sorted((m.name, m.type, m.version, m.scheduler_id, m.state)
                  for m in (svc.registry.get(i) for i in run.models))
    assert rows == [(MLP, "mlp", 1, "s1", "inactive"), (GNN, "gnn", 1, "s1", "inactive")]
    assert [r["registry_calls"] for r in run.ranks] == [2] + [0] * (ranked["n"] - 1)
    assert ranked["gnn_published"] == 1
    for r in run.ranks:
        assert r["rank"] == run.ranks.index(r)
        assert (r["download_rows"], r["topology_rows"]) == (run.download_rows, run.topology_rows)
        assert r["metrics"] == {k: m.to_dict() for k, m in run.metrics.items()}
    assert run.download_rows == one["bf16"].download_rows == DOWNLOADS
    assert not dist.is_initialized()


# -- planted faults -------------------------------------------------------


@pytest.fixture(scope="module")
def faulty(shards):
    return _grouped(shards, 2, rank_init=rank_faults)


def test_a_rank_stepping_on_its_own_gradients_reads_above_twice_the_limit(faulty, one):
    _, run = faulty
    rank1 = run.ranks[1]["leaves"]
    worst = max(max(_moves(rank1[name], one["bf16"].leaves[name],
                           one["start"].leaves[name]).values()) for name in (MLP, GNN))
    assert worst > 2 * MOVE_TOL["bf16"], worst
    with pytest.raises(AssertionError):
        _held(rank1, one["bf16"], one["start"], "bf16")
    # The digests the smoke compares across ranks read it too.
    assert all(run.ranks[1]["leaf_digests"][name] != run.ranks[0]["leaf_digests"][name]
               for name in (MLP, GNN))


def test_a_registering_helper_is_caught(faulty):
    _, run = faulty
    # Each model registered twice: the check of one registration, from
    # rank 0 alone, reads it.
    assert [r["registry_calls"] for r in run.ranks] == [2, 2]
    assert len(run.models) == 2


# -- skips and failures ---------------------------------------------------


def test_a_trainer_refusal_skips_the_model_on_every_rank(shards, monkeypatch):
    """The trainers' ``ValueError`` (no full batches on the data axis) on
    every rank: the GNN is skipped everywhere, the MLP registered, and no
    rank waits in a collective another skipped."""
    monkeypatch.setattr(ttr, "train_gat_ranker", _refuse)
    svc, run = _grouped(shards, 2, rank_init=rank_refuse_gnn)
    assert run.error is None
    assert [svc.registry.get(i).name for i in run.models] == [MLP]
    assert [sorted(r["metrics"]) for r in run.ranks] == [[MLP], [MLP]]


def test_rank_plans():
    assert plan_ranks("cpu") == plan_ranks("cpu", 1)
    assert plan_ranks("cpu").world == 1
    assert plan_ranks("cpu", 4).backend == "gloo"
    assert plan_ranks("cpu", 4).devices == ("cpu",) * 4
    # No card here: one rank, on cuda:0 (the round itself then refuses).
    assert plan_ranks("cuda").world == 1
    assert plan_ranks("cuda", 2) == type(plan_ranks("cuda", 2))(2, "gloo", ("cuda:0", "cuda:0"))
    with pytest.raises(ValueError):
        RankGroup(1, device="cpu")
