"""Port: the trainer service's ranks in serve mode and in the binary,
``dragonfly2_tpu_torch/cli/trainer.py --nproc`` over
``parallel/launch.RankGroup``: one upload to rank 0 trains on every rank,
registers once and feeds the online sink once; ``--train-once`` prints
the reference's lines once; SIGTERM leaves no helper alive; a helper
that fails fails the round with its error, and the next round starts a
new group.  The ranks are gloo groups on the CPU; the spawned ranks
import this module, so it imports no JAX.  The shards and the round are
``tests/test_torch_trainer_ranks.py``'s.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import torch.distributed as dist

from dragonfly2_tpu_torch.cli import trainer as tcli
from dragonfly2_tpu_torch.config import TrainerConfigFile
from dragonfly2_tpu_torch.manager.registry import ModelRegistry
from dragonfly2_tpu_torch.parallel.launch import RankGroup
from dragonfly2_tpu_torch.trainer import service as tsvc
import pytest
from test_torch_trainer_ranks import DOWNLOADS, GNN, MLP, service, train_round, write_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_helper_dies(rank):
    if rank == 1:
        def boom(self, run, session, mesh=None):
            raise RuntimeError("helper boom")
        tsvc.TrainerService._train_gnn = boom


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(str(tmp_path_factory.mktemp("shards")))


def test_a_helper_that_fails_fails_the_round_and_the_next_round_runs(shards):
    group = RankGroup(2, device="cpu", rank_init=rank_helper_dies)
    svc = service(ranks=group)
    try:
        t0 = time.monotonic()
        run = train_round(svc, shards)
        assert run.error is not None and "rank 1: RuntimeError: helper boom" in run.error
        assert len(run.models) == 1  # the MLP, trained before the helper failed
        assert not dist.is_initialized() and group.mesh is None
        assert time.monotonic() - t0 < 60
        generation = group.generation
        again = train_round(svc, shards)
        assert group.generation == generation + 1
        assert again.error is not None and "helper boom" in again.error
    finally:
        group.close()
    assert not dist.is_initialized()


def test_cli_train_once_on_two_ranks_prints_the_reference_lines_once(shards, capsys,
                                                                   monkeypatch):
    monkeypatch.setenv("DRAGONFLY_TRAINER_TRAINING_EPOCHS", "2")
    registry = ModelRegistry()
    assert tcli.run(["--train-once", shards, "--device", "cpu", "--nproc", "2"],
                    registry=registry) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "trainer: training on 2 ranks (gloo)"
    assert len(lines) == 5
    assert lines[3:] == ["trainer: registered parent-bandwidth-mlp v1 (mlp)",
                         "trainer: registered parent-ranker-gnn v1 (gnn)"]
    assert len(registry.list()) == 2
    assert not dist.is_initialized()


class _Sink:
    def __init__(self):
        self.download_rows = 0
        self.topology_rows = 0

    def feed_download_rows(self, rows):
        self.download_rows += len(rows)

    def feed_topology_rows(self, rows):
        self.topology_rows += len(rows)


def test_serve_mode_on_two_ranks_trains_both_registers_once_feeds_the_sink_once(shards, tmp_path):
    from dragonfly2_tpu_torch import rpc

    cfg = TrainerConfigFile()
    cfg.data_dir = str(tmp_path / "staging")
    cfg.server.port = 0
    cfg.training.epochs = 2
    registry = ModelRegistry()
    serving = tcli.serve(cfg, device="cpu", registry=registry, gnn_model="gat", nproc=2)
    try:
        sink = _Sink()
        serving.service.online_sink = sink
        assert len(serving.ranks.helper_pids) == 1
        client = rpc.RemoteTrainer(serving.url, timeout=60.0)
        session = client.open_train_stream(ip="10.0.0.1", hostname="h", scheduler_id="s1")
        session.send_download_shard(os.path.join(shards, "download_0.dfc"))
        session.send_network_topology_shard(os.path.join(shards, "networktopology_0.dfc"))
        key = session.close_and_train(synchronous=True)
        run = serving.service.runs[key]
        assert run.error is None, run.error
        assert len(run.ranks) == 2 and [r["registry_calls"] for r in run.ranks] == [2, 0]
        assert sorted(m.name for m in registry.list()) == [MLP, GNN]
        assert (sink.download_rows, sink.topology_rows) == (DOWNLOADS, run.topology_rows)
        pids = serving.ranks.helper_pids
    finally:
        serving.stop()
    assert not dist.is_initialized()
    for pid in pids:
        assert not _alive(pid)


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def _catches(pid, sig):
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("SigCgt:"):
                return bool(int(line.split()[1], 16) >> (int(sig) - 1) & 1)
    return False


def _spawned_children(pid):
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{task}/children") as f:
            out += [int(c) for c in f.read().split()]
    helpers = []
    for c in out:
        try:
            with open(f"/proc/{c}/cmdline", "rb") as f:
                if b"spawn_main" in f.read():
                    helpers.append(c)
        except OSError:
            pass
    return helpers


def test_sigterm_leaves_no_helper_alive(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO,
               DRAGONFLY_TRAINER_DATA_DIR=str(tmp_path / "staging"),
               DRAGONFLY_TRAINER_SERVER_PORT="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cli.trainer", "--device", "cpu",
         "--nproc", "3"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, (lines, proc.stderr.read())
            lines.append(line.strip())
            if line.startswith("trainer: ingest on "):
                break
        assert lines[0] == "trainer: training on 3 ranks (gloo)"
        helpers = _spawned_children(proc.pid)
        assert len(helpers) == 2 and all(_alive(h) for h in helpers)
        # The boot line prints before the serve loop catches SIGTERM: wait
        # for the binary to catch it (its SigCgt mask), then send it.
        deadline = time.monotonic() + 30
        while not _catches(proc.pid, signal.SIGTERM) and time.monotonic() < deadline:
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        deadline = time.monotonic() + 10
        while any(_alive(h) for h in helpers) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(_alive(h) for h in helpers)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
