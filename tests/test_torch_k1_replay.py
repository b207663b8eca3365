"""The K1 reading's tools on the CPU (``bench/k1_replay``): a flush saved
with ``save_flush`` replays on exactly its tensors; the seeded stress
walks the pad boundaries over store-like rows; and ``chip_smoke``'s
``k1_on_flushes`` saves every flush past the limit, with the bound flags
its tap took, and nothing else.  On the CPU K1's wrapper takes its plain
version, so the planted fault here is a K1 that is off by 1e-3."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.bench import k1_replay
from dragonfly2_tpu_torch.ops import fused_score

CPU = torch.device("cpu")


def _weights(seed=0, dims=(32, 64, 64, 1)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
             rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
            for i in range(len(dims) - 1)]


def _flush(seed=1, n=37, slots=512):
    rng = np.random.default_rng(seed)
    mat = torch.from_numpy(rng.standard_normal((slots, 12)).astype(np.float32))
    s = torch.from_numpy(rng.integers(0, slots, n).astype(np.int32))
    d = torch.from_numpy(rng.integers(0, slots, n).astype(np.int32))
    e = torch.from_numpy(rng.random((n, 8), dtype=np.float32))
    return mat, s, d, e


def test_saved_flush_replays_on_its_tensors(tmp_path):
    w = _weights()
    mlp = fused_score.ServingMLP(w, device=CPU)
    mat, s, d, e = _flush()
    path = k1_replay.save_flush(str(tmp_path / "f.pt"), mat=mat, slots=s, dslots=d, edge=e,
                                weights=w, mlp=mlp, bound_src=np.ones(37, bool),
                                bound_dst=np.arange(37) % 2 == 0, err=3.59e-5, phase="x")
    saved = torch.load(path, weights_only=False)
    assert torch.equal(saved["mirror"], mat) and torch.equal(saved["slots"], s)
    assert torch.equal(saved["k1_blob"], mlp.k1_blob)
    out = k1_replay.replay(path, launches=7, device="cpu")
    assert out["launches"] == 7 and out["rows"] == 37 and out["saved_err_scaled"] == 3.59e-5
    assert out["verdict"] == "none" and out["k1_bits_vary"] == 0 and out["plain_bits_same"]
    assert out["unbound_rows"] == 18 and out["meta"] == {"phase": "x"}
    assert out["plain_vs_f64_scaled"] < 1e-6


def test_stress_walks_the_pad_edges_over_store_like_rows():
    rows = k1_replay.store_like_rows(0, n_hosts=256, slots=1024)
    assert rows.shape == (1024, 12) and np.isfinite(rows).all()
    assert np.array_equal(rows[:256], rows[256:512])
    out = k1_replay.stress(CPU, flushes=60, repeats=2, seed=0, rows=rows)
    assert out["flushes"] == 60 and out["launches"] == 120 and out["rows_min"] == 1
    assert out["max_err_scaled"] == 0.0 and out["k1_bits_vary"] == 0
    assert set(k1_replay.PAD_EDGES) >= {1, 2, 3, 4, 5, 127, 128, 129, 1023, 1024}


@pytest.mark.parametrize("fault", [None, "k1_off_by_1e-3"])
def test_k1_on_flushes_saves_every_flush_past_the_limit(tmp_path, monkeypatch, fault):
    import chip_smoke

    w = _weights()
    mlp = fused_score.ServingMLP(w, device=CPU)
    flushes, bound = [], []
    for i in range(3):
        mat, s, d, e = _flush(seed=i)
        flushes.append((e.numpy(), s.numpy(), d.numpy()))
        bound.append((np.ones(37, bool), np.ones(37, bool)))

    class Scorer:
        pass

    scorer = Scorer()
    scorer.mlp = mlp
    scorer._ref = type("Ref", (), {"weights": w, "post_hoc_masked": True})()
    seen = {"flushes": flushes, "scorers": [scorer] * 3, "mirrors": [mat] * 3,
            "bound": bound, "live_finite": [True] * 3}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, *a, **k: (fn(), 1.0)[1])
    if fault:
        plain = fused_score.fused_gather_mlp_score
        monkeypatch.setattr(fused_score, "fused_gather_mlp_score",
                            lambda *a: plain(*a) + 1e-3)
    err, *_ = chip_smoke.k1_on_flushes(torch, CPU, seen, str(tmp_path), "test")
    saved = sorted(p.name for p in tmp_path.glob("*.pt"))
    if fault is None:
        assert err == 0.0 and saved == []
        return
    assert err > chip_smoke.K1_TOL
    assert saved == [f"k1_flush_test_{i}.pt" for i in range(3)]
    out = k1_replay.replay(str(tmp_path / saved[0]), launches=3, device="cpu")
    assert out["saved_err_scaled"] == pytest.approx(err, rel=0.5) and out["unbound_rows"] == 0
    assert out["meta"] == {"phase": "test", "flush": 0}


def test_pad_rows_read_a_defined_slot_row(monkeypatch):
    """The scorer batcher pads a flush with rows of slot 0, the last slot
    the store's free list hands out: K1 reads row 0 before any host is
    bound there.  With the store's allocations poisoned (NaN where numpy
    leaves memory uninitialized), the padded rows must still score
    finite: the slot matrix is zeroed."""
    from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
    from dragonfly2_tpu_torch.scheduler.featcache import HostFeatureCache
    from dragonfly2_tpu_torch.sim.swarm import host_from_latent

    empty = np.empty

    def poisoned(shape, dtype=float, **kw):
        out = empty(shape, dtype, **kw)
        if np.dtype(dtype).kind == "f":
            out.fill(np.nan)
        return out

    monkeypatch.setattr(np, "empty", poisoned)
    store = HostFeatureCache(max_hosts=64)
    monkeypatch.setattr(np, "empty", empty)
    hosts = [host_from_latent(lh) for lh in SyntheticCluster(num_hosts=8, seed=0).hosts]
    store.gather(hosts)
    assert all(h._cols[1] != 0 for h in hosts)
    scorer = FusedMLPScorer(store, _weights(), device=CPU)
    real = np.array([hosts[1]._cols[1], hosts[2]._cols[1]])
    src = np.concatenate([real, np.zeros(6, np.int64)])
    scores = scorer.score(np.zeros((8, 8), np.float32), src_buckets=src,
                          dst_buckets=np.zeros(8, np.int64))
    assert np.isfinite(scores).all()
