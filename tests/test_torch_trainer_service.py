"""Port parity: the trainer service and its binary,
``dragonfly2_tpu_torch/trainer/service.py`` and ``cli/trainer.py``,
against ``dragonfly2_tpu/trainer/service.py`` and ``cli/trainer.py``.

The same DFC1 shards go through both services (the port's on
``device="cpu"``).  Both train from their own seeded inits (other weights
for the same seed), so the models are compared on what the reference
promises across packages and on quality:

- exact: the run record's row counts, the registered names, types and
  versions, the GNN artifact's buckets, the MLP artifact's
  standardization and drift-baseline bins, the staged bytes, chunk
  sequencing, the reference-CSV conversion (but the topology rows'
  freshness column, exp(-age in hours) against each conversion's wall
  clock: 1e-3) and the rows fed to an online sink;
- quality: every model's validation MAE below the train-mean predictor's
  on the same validation rows, and the two packages' MAEs within 15 % of
  each other (10 epochs from different inits).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

from dragonfly2_tpu.manager.registry import ModelRegistry as JRegistry
from dragonfly2_tpu.trainer import export as jexport
from dragonfly2_tpu.trainer import service as jsvc
from dragonfly2_tpu.trainer import train as jtr
from dragonfly2_tpu_torch.cli import trainer as tcli
from dragonfly2_tpu_torch.lifecycle.daemon import GLOBAL_KEY, LifecycleConfig, LifecycleDaemon
from dragonfly2_tpu_torch.manager.registry import ModelRegistry as TRegistry
from dragonfly2_tpu_torch.records import csv_compat
from dragonfly2_tpu_torch.records.columnar import ColumnarReader, ColumnarWriter
from dragonfly2_tpu_torch.records.features import (
    DOWNLOAD_COLUMNS,
    DOWNLOAD_FEATURE_DIM,
    TOPO_COLUMNS,
    mask_post_hoc,
    topology_to_rows,
)
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.trainer import export
from dragonfly2_tpu_torch.trainer import service as tsvc
from dragonfly2_tpu_torch.trainer import train as ttr
from dragonfly2_tpu_torch.trainer.ingest import EdgeBatches

HOSTS, DOWNLOADS, TOPOLOGY = 256, 1024, 128
TRAIN = dict(epochs=10, learning_rate=3e-3, warmup_steps=5)
MAE_BAND = 0.15


def _write_shards(directory, seed=0):
    os.makedirs(directory, exist_ok=True)
    cluster = SyntheticCluster(num_hosts=HOSTS, seed=seed)
    with ColumnarWriter(os.path.join(directory, "download_0.dfc"), DOWNLOAD_COLUMNS) as w:
        w.append(cluster.generate_feature_rows(DOWNLOADS, seed=seed))
    with ColumnarWriter(os.path.join(directory, "networktopology_0.dfc"), TOPO_COLUMNS) as w:
        for record in cluster.generate_topology_records(TOPOLOGY):
            w.append(topology_to_rows(record, now_ns=record.created_at))
    return directory


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return _write_shards(str(tmp_path_factory.mktemp("shards")))


def _train(svc, directory):
    session = svc.open_train_stream(ip="10.0.0.1", hostname="trainer-host", scheduler_id="s1")
    session.send_download_shard(os.path.join(directory, "download_0.dfc"))
    session.send_network_topology_shard(os.path.join(directory, "networktopology_0.dfc"))
    return svc.runs[session.close_and_train()]


@pytest.fixture(scope="module", params=["hop", "gat"])
def runs(request, shards):
    gnn = request.param
    jreg, treg = JRegistry(), TRegistry()
    jrun = _train(jsvc.TrainerService(jreg, train_config=jtr.TrainConfig(**TRAIN),
                                      gnn_model=gnn), shards)
    trun = _train(tsvc.TrainerService(treg, train_config=ttr.TrainConfig(**TRAIN),
                                      gnn_model=gnn, device="cpu"), shards)
    return gnn, dict(jrun=jrun, trun=trun, jreg=jreg, treg=treg)


def test_run_records_match(runs):
    _, r = runs
    jrun, trun = r["jrun"], r["trun"]
    assert jrun.error is None and trun.error is None
    assert (trun.key, trun.download_rows, trun.topology_rows) == (
        jrun.key, jrun.download_rows, jrun.topology_rows) == (trun.key, DOWNLOADS, 5 * TOPOLOGY)
    assert trun.models == jrun.models
    assert list(trun.metrics) == list(jrun.metrics) == [tsvc.MLP_MODEL_NAME, tsvc.GNN_MODEL_NAME]

    def rows(reg, ids):
        return [(m.name, m.type, m.version, m.scheduler_id, m.state.value)
                for m in map(reg.get, ids)]

    assert rows(r["treg"], trun.models) == rows(r["jreg"], jrun.models)


def _artifacts(reg, ids, loader):
    return [loader(reg.load_artifact(reg.get(i))) for i in ids]


def test_artifacts_match_and_load_in_both_packages(runs):
    _, r = runs
    t_mlp, t_gnn = _artifacts(r["treg"], r["trun"].models, export.load_scorer)
    j_mlp, j_gnn = _artifacts(r["jreg"], r["jrun"].models, jexport.load_scorer)
    assert np.array_equal(t_gnn.buckets, j_gnn.buckets)
    assert t_gnn.embeddings.shape == j_gnn.embeddings.shape
    for attr in ("feat_mean", "feat_std", "train_bin_edges", "train_bin_fracs"):
        assert np.array_equal(getattr(t_mlp, attr), getattr(j_mlp, attr)), attr
    # The port's blobs load in the JAX package and score alike.
    tb = [r["treg"].load_artifact(r["treg"].get(i)) for i in r["trun"].models]
    feats = np.random.default_rng(0).standard_normal((32, DOWNLOAD_FEATURE_DIM)).astype(np.float32)
    assert np.max(np.abs(jexport.load_scorer(tb[0]).score(feats) - t_mlp.score(feats))) <= 1e-6
    b = t_gnn.buckets[:16]
    assert np.max(np.abs(jexport.load_scorer(tb[1]).score(None, src_buckets=b, dst_buckets=b[::-1])
                         - t_gnn.score(None, src_buckets=b, dst_buckets=b[::-1]))) <= 1e-6


def _mean_predictor_mae(shards):
    """The train-mean predictor's MAE on each model's validation rows, cut
    as the service cuts them."""
    rows = ColumnarReader(os.path.join(shards, "download_0.dfc")).to_array()
    masked = np.array(rows, copy=True)
    masked[:, 2:2 + DOWNLOAD_FEATURE_DIM] = mask_post_hoc(masked[:, 2:2 + DOWNLOAD_FEATURE_DIM])
    order = np.random.default_rng(0).permutation(len(rows))
    n_val = max(int(len(rows) * 0.1), 1)
    batch = int(min(4096, max(64, 2 ** int(np.log2(max(len(rows) // 8, 64))))))
    train_rows, val_rows = masked[order[n_val:]], masked[order[:n_val]]
    val = EdgeBatches(val_rows, batch_size=min(batch, len(val_rows)), shuffle=False,
                      drop_remainder=False)
    target = np.concatenate([t for _, t, _, _ in val.epoch(0)])
    mlp = float(np.mean(np.abs(target - train_rows[:, -1].mean())))
    y = rows[:, -1]
    val_idx, train_idx = ttr.split_edges(len(rows), 0)
    gnn = float(np.mean(np.abs(y[val_idx] - y[train_idx].mean())))
    return {tsvc.MLP_MODEL_NAME: mlp, tsvc.GNN_MODEL_NAME: gnn}


def test_models_beat_the_mean_predictor_and_agree_in_quality(runs, shards):
    _, r = runs
    base = _mean_predictor_mae(shards)
    for name, floor in base.items():
        t_mae, j_mae = r["trun"].metrics[name].mae, r["jrun"].metrics[name].mae
        assert t_mae < floor and j_mae < floor, (name, t_mae, j_mae, floor)
        assert abs(t_mae - j_mae) <= MAE_BAND * j_mae, (name, t_mae, j_mae)


def _chunks(path, sizes=(5, 100, 997, 31)):
    raw = open(path, "rb").read()
    out, at, i = [], 0, 0
    while at < len(raw):
        n = sizes[i % len(sizes)]
        out.append(raw[at:at + n])
        at, i = at + n, i + 1
    return out


class _Sink:
    def __init__(self):
        self.download, self.topology = [], []

    def feed_download_rows(self, rows):
        self.download.append(np.array(rows))

    def feed_topology_rows(self, rows):
        self.topology.append(np.array(rows))


def test_chunk_sequencing_dedup_and_gap_match(shards, tmp_path):
    chunks = _chunks(os.path.join(shards, "download_0.dfc"))
    state = {}
    for name, mod in (("jax", jsvc), ("port", tsvc)):
        kw = {} if name == "jax" else dict(device="cpu")
        svc = mod.TrainerService(data_dir=str(tmp_path / name), **kw)
        s = svc.open_train_stream(ip="10.0.0.2", hostname="h", scheduler_id="s")
        for seq, data in enumerate(chunks[:3]):
            svc.receive_shard_bytes(s, "download", "d.dfc", data, seq=seq)
        svc.receive_shard_bytes(s, "download", "d.dfc", chunks[1], seq=1)     # a retry
        with pytest.raises(ValueError, match="chunk gap"):
            svc.receive_shard_bytes(s, "download", "d.dfc", chunks[4], seq=4)
        with pytest.raises(RuntimeError, match="data_dir"):
            mod.TrainerService(**kw).receive_shard_bytes(s, "download", "x", b"", seq=0)
        state[name] = (open(s.download_shards[0], "rb").read(), dict(s.chunk_seq),
                       os.path.relpath(s.download_shards[0], str(tmp_path / name)))
    assert state["jax"] == state["port"]
    assert state["port"][0] == b"".join(chunks[:3])


def test_rows_fed_to_the_online_sink_match(shards, tmp_path):
    dl = _chunks(os.path.join(shards, "download_0.dfc"))
    topo = _chunks(os.path.join(shards, "networktopology_0.dfc"), sizes=(64, 3, 200))
    sinks = {}
    for name, mod in (("jax", jsvc), ("port", tsvc)):
        kw = {} if name == "jax" else dict(device="cpu")
        sinks[name] = sink = _Sink()
        svc = mod.TrainerService(data_dir=str(tmp_path / name), online_sink=sink, **kw)
        s = svc.open_train_stream(ip="10.0.0.3", hostname="h", scheduler_id="s")
        for seq, data in enumerate(dl[:len(dl) // 2]):
            svc.receive_shard_bytes(s, "download", "d.dfc", data, seq=seq)
        # The client reconnects and resends the whole shard: only new rows feed.
        s2 = svc.open_train_stream(ip="10.0.0.3", hostname="h", scheduler_id="s")
        for seq, data in enumerate(dl):
            svc.receive_shard_bytes(s2, "download", "d.dfc", data, seq=seq)
        for seq, data in enumerate(topo):
            svc.receive_shard_bytes(s2, "networktopology", "t.dfc", data, seq=seq)
    got = {k: (np.concatenate(v.download), np.concatenate(v.topology)) for k, v in sinks.items()}
    assert all(np.array_equal(a, b) for a, b in zip(got["jax"], got["port"]))
    want = ColumnarReader(os.path.join(shards, "download_0.dfc")).to_array()
    assert np.array_equal(got["port"][0], want)


def test_online_feed_reaches_the_lifecycle_daemon(shards, tmp_path):
    daemon = LifecycleDaemon(TRegistry(), None, config=LifecycleConfig(), device="cpu")
    svc = tsvc.TrainerService(data_dir=str(tmp_path), online_sink=daemon, device="cpu")
    s = svc.open_train_stream(ip="10.0.0.4", hostname="h", scheduler_id="s")
    # 64 KiB chunks: a few feeds, inside the trainer queue's capacity.
    for seq, data in enumerate(_chunks(os.path.join(shards, "download_0.dfc"), (1 << 16,))):
        svc.receive_shard_bytes(s, "download", "d.dfc", data, seq=seq)
    assert daemon.records_seen(GLOBAL_KEY) == DOWNLOADS
    assert daemon.records_dropped(GLOBAL_KEY) == 0


def test_reference_csv_shards_convert_alike_and_train(tmp_path):
    cluster = SyntheticCluster(num_hosts=48, seed=4)
    dl_csv, topo_csv = str(tmp_path / "dl.csv"), str(tmp_path / "topo.csv")
    csv_compat.write_download_csv(cluster.generate_downloads(160), dl_csv)
    csv_compat.write_topology_csv(cluster.generate_topology_records(40), topo_csv)
    converted = {}
    for name, mod in (("jax", jsvc), ("port", tsvc)):
        kw = {} if name == "jax" else dict(device="cpu")
        sink = _Sink()
        svc = mod.TrainerService(data_dir=str(tmp_path / name), online_sink=sink,
                                 train_config=(jtr if name == "jax" else ttr).TrainConfig(
                                     epochs=1, warmup_steps=1), **kw)
        s = svc.open_train_stream(ip="10.0.0.5", hostname="h", scheduler_id="s")
        svc.receive_shard_bytes(s, "download", "dl.csv", open(dl_csv, "rb").read(), seq=0)
        svc.receive_shard_bytes(s, "networktopology", "topo.csv", open(topo_csv, "rb").read())
        assert sink.download == sink.topology == []     # CSV streams skip the online decode
        svc._normalize_session(s)
        converted[name] = [ColumnarReader(p).to_array() for p in s.download_shards
                           + s.topology_shards]
        if name == "port":
            run = svc.runs[s.close_and_train()]
            assert run.error is None and run.download_rows > 64
            assert [svc.registry.get(m).type for m in run.models] == ["mlp", "gnn"]
    (jd, jt), (td, tt) = converted["jax"], converted["port"]
    assert np.array_equal(jd, td)
    # Topology rows: every column equal but the last, freshness =
    # exp(-age in hours) against the wall clock of each conversion.
    assert np.array_equal(jt[:, :-1], tt[:, :-1])
    assert np.max(np.abs(jt[:, -1] - tt[:, -1])) <= 1e-3


def test_cli_train_once_prints_the_reference_lines(shards, capsys, monkeypatch):
    monkeypatch.setenv("DRAGONFLY_TRAINER_TRAINING_EPOCHS", "3")
    reg = TRegistry()
    assert tcli.run(["--train-once", shards, "--device", "cpu"], registry=reg) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4
    for name, line in zip((tsvc.MLP_MODEL_NAME, tsvc.GNN_MODEL_NAME), lines[:2]):
        assert re.fullmatch(rf"trainer: {name}: mae=\d+\.\d{{4}} mse=\d+\.\d{{4}} "
                            rf"f1=\d\.\d{{3}} \({DOWNLOADS} rows\)", line), line
    assert lines[2:] == ["trainer: registered parent-bandwidth-mlp v1 (mlp)",
                         "trainer: registered parent-ranker-gnn v1 (gnn)"]
    models = reg.list()
    assert len(models) == 2
    assert isinstance(export.load_scorer(reg.load_artifact(models[0])),
                      (export.MLPScorer, export.GNNScorer))


def test_cli_serve_mode_and_missing_shards_exit_nonzero(tmp_path, capsys, monkeypatch):
    # Serve mode with a gRPC port on a machine without grpc: exit 2,
    # naming the package.
    from _torch_nogrpc import block_grpc

    block_grpc(monkeypatch)
    monkeypatch.setenv("DRAGONFLY_TRAINER_SERVER_GRPC_PORT", "0")
    assert tcli.run(["--device", "cpu"]) == 2
    assert "'grpc' is not installed" in capsys.readouterr().err
    assert tcli.run(["--train-once", str(tmp_path), "--device", "cpu"]) == 1
    assert "no download*.dfc shards" in capsys.readouterr().err


def test_reference_config_file_loads_alike_and_trace_flags_are_refused(tmp_path, capsys):
    import dataclasses

    from dragonfly2_tpu.config import schema as jschema
    from dragonfly2_tpu_torch.config import schema as tschema

    path = tmp_path / "trainer.yaml"
    path.write_text(
        "training: {epochs: 4, learning_rate: 0.001, warmup_steps: 3}\n"
        "server: {port: 9191}\n"
        "lifecycle: {regions: [eu, us], canary_percent: 20}\n"
        "tracing: {sample_rate: 0.5}\n"
        "telemetry: {journal_interval_s: 2.0}\n"
    )
    j = jschema.load_config(jschema.TrainerConfigFile, str(path), env=False)
    t = tschema.load_config(tschema.TrainerConfigFile, str(path), env=False)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    bad = tmp_path / "bad.yaml"
    bad.write_text("training: {epochs: 0}\n")
    for mod in (jschema, tschema):
        with pytest.raises(mod.ConfigError, match="epochs"):
            mod.load_config(mod.TrainerConfigFile, str(bad), env=False)
    # The reference's tracing and telemetry flags are the port's too: each
    # parses and the binary runs on (what they write is held in
    # tests/test_torch_cli_telemetry.py).  An unknown flag is still refused.
    from dragonfly2_tpu_torch.utils import tracing as ttracing

    exporter, enabled = ttracing.default_tracer.exporter, ttracing.enabled()
    try:
        for flag in ("--trace-file", "--otlp", "--trace-log", "--metric-journal"):
            argv = [flag, str(tmp_path / flag.strip("-")), "--train-once",
                    str(tmp_path / "empty"), "--device", "cpu"]
            assert tcli.run(argv) == 1
            assert "no download*.dfc shards" in capsys.readouterr().err
    finally:
        ttracing.default_tracer.exporter = exporter
        ttracing.set_enabled(enabled)
    with pytest.raises(SystemExit) as exc:
        tcli.run(["--jaeger", str(tmp_path / "x"), "--device", "cpu"])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
