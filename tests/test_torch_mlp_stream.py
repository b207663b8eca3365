"""Port parity: the MLP regressor and the streaming trainer,
``dragonfly2_tpu_torch/{models/mlp,trainer/streaming}.py`` against
``dragonfly2_tpu/{models/mlp,trainer/streaming}.py``, and the MLP half
of both packages' ``trainer/export.py``.

The port runs on the CPU (``device="cpu"``); the JAX package on its CPU
backend.  Parity runs carry the JAX trainer's flax params into the port
(``load_flax_params``) before the first batch: a seed initializes the
two packages with other weights.

Tolerances, stated:
- ``MLPRegressor`` forward: 1e-5 absolute for a float32 config; 2e-2
  relative L2 for bfloat16 (XLA and torch round the bf16 products and
  gelus at slightly other places);
- the streaming trainers run twice, with bf16 compute (``MLPConfig()``)
  and with a float32 config; losses per step within 5e-3 relative
  (bf16) and 1e-4 (float32);
- trained weights, per exported leaf: ``‖port − jax‖ / ‖jax − initial‖``,
  the relative L2 of the two trainers' moves from the common start,
  within 1.5e-2 (bf16) and 1e-4 (float32).  Measured on the CPU: at most
  6.0e-3 (bf16) and 7.7e-6 (float32).  The check must catch a planted
  fault in the port's optimizer, and does (``test_a_planted_optimizer_
  fault_fails_the_weight_check`` asks for more than twice the limit);
  the largest leaf's reading, bf16 / float32: weight decay 0 4.0e-2 /
  4.0e-2, no gradient clip 1.3e-1 / 1.3e-1, the update count starting at
  1 (bias correction and learning rate a step ahead) 1.8e-1 / 1.8e-1.
  The weight decay is 0.1 here, not 1e-4, so that its term is visible:
  at 1e-4 it moves a weight by ~1e-7 in 12 steps;
- moments, the drift-snapshot ring, ``feat_mean``/``feat_std`` and the
  drift bins: exact (numpy verbatim on the same rows);
- scores of blobs across packages: 1e-6 absolute (the same numpy scorer
  on the same float32 weights);
- the port's resume: bit for bit.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models import mlp as jm
from dragonfly2_tpu.trainer import export as jexport
from dragonfly2_tpu.trainer import streaming as jstream
from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.models import mlp as tm
from dragonfly2_tpu_torch.records.features import (
    DOWNLOAD_COLUMNS,
    DOWNLOAD_FEATURE_DIM,
    mask_post_hoc,
)
from dragonfly2_tpu_torch.trainer import export
from dragonfly2_tpu_torch.trainer import streaming as tstream
from dragonfly2_tpu_torch.trainer import train as ttr

BATCH, STEPS = 64, 12
STREAM_KW = dict(batch_size=BATCH, warmup_steps=4, learning_rate=3e-3, weight_decay=0.1,
                 snapshot_rows=512, seed=11)
LOSS_RTOL = {"bf16": 5e-3, "f32": 1e-4}
MOVE_TOL = {"bf16": 1.5e-2, "f32": 1e-4}


def _rows(n, seed=0):
    """Download rows in DOWNLOAD_COLUMNS layout with a linear target."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, len(DOWNLOAD_COLUMNS)), np.float32)
    feats = (rng.standard_normal((n, DOWNLOAD_FEATURE_DIM)) * 3.0 + 1.0).astype(np.float32)
    rows[:, 2:2 + DOWNLOAD_FEATURE_DIM] = feats
    w = rng.standard_normal(DOWNLOAD_FEATURE_DIM).astype(np.float32) * 0.3
    rows[:, -1] = 12.0 + feats @ w
    return rows


def _chunks(rows, sizes=(50, 70, 33, 91)):
    """Uneven feed chunks: batches straddle them (the leftover logic)."""
    out, i, k = [], 0, 0
    while i < len(rows):
        out.append(rows[i:i + sizes[k % len(sizes)]])
        i += sizes[k % len(sizes)]
        k += 1
    return out


def _flax_init(cfg, seed=0):
    p = jm.MLPRegressor(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((2, cfg.in_dim)))
    return jax.tree_util.tree_map(np.asarray, p["params"])


def _configs(dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return (jm.MLPConfig(hidden=(48, 32, 16), dropout=0.1, dtype=jd),
            tm.MLPConfig(hidden=(48, 32, 16), dropout=0.1, dtype=td))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_forward_matches_flax(dtype):
    jcfg, tcfg = _configs(dtype)
    params = _flax_init(jcfg, seed=3)
    model = tm.load_flax_params(tm.MLPRegressor(tcfg), params)
    x = np.random.default_rng(4).standard_normal((257, DOWNLOAD_FEATURE_DIM)).astype(np.float32)
    want = np.asarray(jm.MLPRegressor(jcfg).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (257,)
    got = got.numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


def test_mlp_flax_paths_round_trip_and_a_bad_leaf_raises():
    jcfg, tcfg = _configs("f32")
    params = _flax_init(jcfg)
    model = tm.load_flax_params(tm.MLPRegressor(tcfg), params)
    assert [n for n, _ in model.named_children()] == ["Dense_0", "Dense_1", "Dense_2", "Dense_3"]
    back = tm.to_flax_params(model)
    flat_a, flat_b = tg._flatten(back), tg._flatten(params)
    assert set(flat_a) == set(flat_b)
    assert all(np.array_equal(flat_a[k], flat_b[k]) for k in flat_b)
    missing = {k: v for k, v in params.items() if k != "Dense_3"}
    with pytest.raises(ValueError):
        tm.load_flax_params(tm.MLPRegressor(tcfg), missing)
    misshapen = dict(params, Dense_0={"kernel": np.zeros((31, 48), np.float32),
                                      "bias": np.zeros(48, np.float32)})
    with pytest.raises(ValueError):
        tm.load_flax_params(tm.MLPRegressor(tcfg), misshapen)


def test_dropout_only_in_training_mode():
    _, tcfg = _configs("f32")
    model = tm.MLPRegressor(tcfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32))
    with torch.no_grad():
        a, b = model(x), model(x)
        c = model(x, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_warm_start_shifts_the_output_bias_as_the_jax_package():
    jcfg, tcfg = _configs("f32")
    params = _flax_init(jcfg)
    want = jax.tree_util.tree_map(np.asarray, jm.warm_start_output_bias(params, 12.5))
    model = tm.warm_start_output_bias(tm.load_flax_params(tm.MLPRegressor(tcfg), params), 12.5)
    got = tm.to_flax_params(model)
    for k in want:
        np.testing.assert_array_equal(got[k]["bias"], want[k]["bias"])


@pytest.mark.parametrize("masked", [True, False])
def test_export_from_state_matches_the_jax_package(masked):
    jcfg, tcfg = _configs("f32")
    params = _flax_init(jcfg, seed=5)
    rng = np.random.default_rng(6)
    mean = rng.standard_normal(32).astype(np.float32)
    std = (rng.random(32) + 0.5).astype(np.float32)
    rows = rng.standard_normal((300, 32)).astype(np.float32)
    jstate = types.SimpleNamespace(params=params, feat_mean=mean, feat_std=std)
    tstate = ttr.TrainState(model=tm.load_flax_params(tm.MLPRegressor(tcfg), params), opt=None,
                            generator=None, feat_mean=mean, feat_std=std)
    want = jexport.export_from_state(jstate, post_hoc_masked=masked, train_feature_rows=rows)
    got = export.export_from_state(tstate, post_hoc_masked=masked, train_feature_rows=rows)
    assert export.scorer_to_bytes(got) == jexport.scorer_to_bytes(want)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    np.testing.assert_array_equal(got.score(x), want.score(x))


# ---------------------------------------------------------------------------
# The streaming trainer: JAX against the port
# ---------------------------------------------------------------------------


def _record_losses(trainer, attr, index):
    """Wrap a trainer's step callable to log each step's loss."""
    losses = []
    step = getattr(trainer, attr)

    def recording(*args):
        out = step(*args)
        losses.append(float(out[index] if index is not None else out))
        return out

    setattr(trainer, attr, recording)
    return losses


def _stream_model_configs(dtype):
    if dtype == "bf16":
        return jm.MLPConfig(), tm.MLPConfig()
    return jm.MLPConfig(dtype=jnp.float32), tm.MLPConfig(dtype=torch.float32)


def _port_stream(tcfg, p0, rows, fault=None):
    """A port trainer from the flax params ``p0``, with an optional
    planted optimizer fault, fed ``rows`` in uneven chunks."""
    pt = tstream.StreamingTrainer(tstream.StreamingConfig(**STREAM_KW), tcfg, device="cpu")
    tm.load_flax_params(pt.model, p0)
    if fault == "no_weight_decay":
        pt.opt.weight_decay = 0.0
    elif fault == "no_clip":
        pt.opt.MAX_NORM = float("inf")
    elif fault == "count_ahead":
        pt.opt.count = 1
    for chunk in _chunks(rows):
        pt.feed(chunk)
    pt.end_of_stream()
    return pt


@pytest.fixture(scope="module", params=["bf16", "f32"])
def streams(request):
    jcfg, tcfg = _stream_model_configs(request.param)
    rows = _rows(STEPS * BATCH + 37, seed=2)
    jt = jstream.StreamingTrainer(jstream.StreamingConfig(**STREAM_KW), jcfg)
    p0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jt.params)
    pt = _port_stream(tcfg, p0, rows)
    jl = _record_losses(jt, "_step_fn", 2)
    pl = _record_losses(pt, "_train_step", None)
    for chunk in _chunks(rows):
        jt.feed(chunk)
    jt.end_of_stream()
    return dict(dtype=request.param, tcfg=tcfg, rows=rows, p0=p0, jt=jt, pt=pt, jl=jl, pl=pl,
                j_steps=jt.run(idle_timeout=0.1), p_steps=pt.run(idle_timeout=0.1))


def _move_errors(port_scorer, jax_scorer, p0):
    """Per exported leaf, ``‖port − jax‖ / ‖jax − initial‖``."""
    out = []
    for i, ((pw, pb), (jw, jb)) in enumerate(zip(port_scorer.weights, jax_scorer.weights)):
        for name, got, want in (("kernel", pw, jw), ("bias", pb, jb)):
            start = np.asarray(p0[f"Dense_{i}"][name], np.float32)
            out.append(float(np.linalg.norm(got - want) / np.linalg.norm(want - start)))
    return out


def test_stream_steps_and_losses_match(streams):
    assert streams["j_steps"] == streams["p_steps"] == STEPS
    assert streams["pt"].step == STEPS and streams["pt"].opt.count == STEPS
    assert streams["pt"].records_seen == streams["jt"].records_seen == STEPS * BATCH
    assert len(streams["pl"]) == len(streams["jl"]) == STEPS
    np.testing.assert_allclose(streams["pl"], streams["jl"], rtol=LOSS_RTOL[streams["dtype"]])
    assert streams["pt"].last_loss is not None and streams["pt"].last_loss.dim() == 0


def test_stream_moments_and_snapshot_ring_equal(streams):
    jt, pt = streams["jt"], streams["pt"]
    for k, v in jt.moments.to_arrays().items():
        np.testing.assert_array_equal(pt.moments.to_arrays()[k], v)
    np.testing.assert_array_equal(pt.moments.std, jt.moments.std)
    assert (pt._snapshot_pos, pt._snapshot_count) == (jt._snapshot_pos, jt._snapshot_count)
    np.testing.assert_array_equal(pt.snapshot_feature_rows(), jt.snapshot_feature_rows())


def test_stream_exports_match_and_blobs_load_across_packages(streams):
    jt, pt = streams["jt"], streams["pt"]
    js, ps = jt.export_scorer(), pt.export_scorer()
    for name in ("feat_mean", "feat_std", "train_bin_edges", "train_bin_fracs"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(js, name))
    assert ps.post_hoc_masked and js.post_hoc_masked
    assert len(ps.weights) == len(js.weights) == 4
    for (pw, pb), (jw, jb) in zip(ps.weights, js.weights):
        assert pw.shape == jw.shape and pb.shape == jb.shape and pw.dtype == np.float32
    moves = _move_errors(ps, js, streams["p0"])
    assert max(moves) <= MOVE_TOL[streams["dtype"]], moves
    p_blob, j_blob = export.scorer_to_bytes(ps), jexport.scorer_to_bytes(js)
    x = _rows(200, seed=9)[:, 2:2 + DOWNLOAD_FEATURE_DIM]
    np.testing.assert_allclose(jexport.load_scorer(p_blob).score(x), ps.score(x), atol=1e-6)
    np.testing.assert_allclose(export.load_scorer(j_blob).score(x), js.score(x), atol=1e-6)


@pytest.mark.parametrize("fault", ["no_weight_decay", "no_clip", "count_ahead"])
def test_a_planted_optimizer_fault_fails_the_weight_check(streams, fault):
    pt = _port_stream(streams["tcfg"], streams["p0"], streams["rows"], fault)
    assert pt.run(idle_timeout=0.1) == STEPS
    moves = _move_errors(pt.export_scorer(), streams["jt"].export_scorer(), streams["p0"])
    assert max(moves) > 2 * MOVE_TOL[streams["dtype"]], moves


def test_stream_export_tracks_the_module():
    """The exported numpy scorer against the module's own predictions on
    held rows (float32 model: the numpy scorer's f32 arithmetic)."""
    pt = tstream.StreamingTrainer(
        tstream.StreamingConfig(**STREAM_KW),
        tm.MLPConfig(hidden=(64, 64, 32), dtype=torch.float32), device="cpu")
    for chunk in _chunks(_rows(4 * BATCH, seed=3)):
        pt.feed(chunk)
    assert pt.run(idle_timeout=0.05) == 4
    held = _rows(256, seed=4)
    feats = held[:, 2:2 + DOWNLOAD_FEATURE_DIM]
    x = (mask_post_hoc(feats) - pt.moments.mean.astype(np.float32)) \
        / pt.moments.std.astype(np.float32)
    with torch.no_grad():
        want = pt.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pt.export_scorer().score(feats), want, atol=1e-4)


def _snapshot_state(trainer):
    return dict(
        params={k: v.clone() for k, v in trainer.model.state_dict().items()},
        mu=[m.clone() for m in trainer.opt.mu], nu=[v.clone() for v in trainer.opt.nu],
        count=trainer.opt.count, step=trainer.step, records=trainer.records_seen,
        moments=trainer.moments.to_arrays(), ring=trainer.snapshot_feature_rows().copy(),
        pos=trainer._snapshot_pos, blob=export.scorer_to_bytes(trainer.export_scorer()),
    )


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert all(torch.equal(x, y) for x, y in zip(a["mu"], b["mu"]))
    assert all(torch.equal(x, y) for x, y in zip(a["nu"], b["nu"]))
    for k in ("count", "step", "records", "pos", "blob"):
        assert a[k] == b[k], k
    for k in a["moments"]:
        np.testing.assert_array_equal(a["moments"][k], b["moments"][k])
    np.testing.assert_array_equal(a["ring"], b["ring"])


def test_resume_continues_bit_identically(tmp_path):
    cfg = tstream.StreamingConfig(checkpoint_every=6, **STREAM_KW)
    mcfg = tm.MLPConfig(hidden=(64, 32, 16))
    rows = _rows(10 * BATCH, seed=5)
    first = tstream.StreamingTrainer(cfg, mcfg, checkpoint_dir=str(tmp_path), device="cpu")
    for i in range(6):
        first.feed(rows[i * BATCH:(i + 1) * BATCH])
    assert first.run(idle_timeout=0.01) == 6          # checkpoints at step 6
    resumed = tstream.StreamingTrainer(cfg, mcfg, checkpoint_dir=str(tmp_path), device="cpu")
    assert resumed.resume()
    _assert_same_state(_snapshot_state(resumed), _snapshot_state(first))
    for trainer in (first, resumed):
        for i in range(6, 10):
            trainer.feed(rows[i * BATCH:(i + 1) * BATCH])
        assert trainer.run(idle_timeout=0.01) == 4
    _assert_same_state(_snapshot_state(resumed), _snapshot_state(first))


def test_resume_without_a_checkpoint_is_false(tmp_path):
    t = tstream.StreamingTrainer(tstream.StreamingConfig(**STREAM_KW), device="cpu",
                                 checkpoint_dir=str(tmp_path / "none"))
    assert t.resume() is False


def test_running_moments_equal_the_jax_package():
    rng = np.random.default_rng(8)
    jr, tr = jstream.RunningMoments(5), tstream.RunningMoments(5)
    for n in (1, 7, 0, 64, 3):
        b = rng.standard_normal((n, 5)).astype(np.float32) * 4
        jr.update(b)
        tr.update(b)
        np.testing.assert_array_equal(tr.std, jr.std)
    again = tstream.RunningMoments.from_arrays(tr.to_arrays())
    np.testing.assert_array_equal(again.mean, jr.mean)
    assert again.count == jr.count


def test_queue_backpressure_and_end_of_stream():
    t = tstream.StreamingTrainer(tstream.StreamingConfig(queue_capacity=1, **STREAM_KW),
                                 device="cpu")
    rows = _rows(BATCH, seed=1)
    assert t.feed(rows[:40], block=False)
    assert not t.feed(rows[40:], block=False)       # full: dropped, not blocked
    assert t.run(idle_timeout=0.01) == 0            # 40 rows < one batch: kept
    assert t._leftover is not None and len(t._leftover) == 40
    t.feed(rows[40:])
    assert t.run(idle_timeout=0.01) == 1 and t.records_seen == BATCH
    t.end_of_stream()
    assert t.run() == 0                             # the sentinel ends the run


def test_a_cuda_trainer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tstream.StreamingTrainer(device="cuda")
