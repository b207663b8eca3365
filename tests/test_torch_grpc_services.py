"""The port's gRPC half, trainer and manager side: port counterparts of
``tests/test_grpc.py``'s ``TestTrainerCLIServe``, ``TestManagerGRPC``
(``test_model_lifecycle_over_grpc``, ``test_keepalive_and_scheduler_listing``),
``TestFullGRPCLoop`` and ``TestTrainerGRPC``, with every trainer on the
CPU.  The reference's three RBAC / PAT tests (``TestManagerGRPC``'s
``test_rbac_enforced_on_grpc_port``, ``test_disable_bites_grpc_sessions_
immediately``, ``test_pats_authenticate_on_grpc_port``) run in
``tests/test_torch_security.py``; here each of the manager's RBAC, CA
and TLS arguments takes effect, as the reference's.  Each binary given a
gRPC setting on a machine without ``grpc`` exits 2 naming the package.
Every server binds port 0.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from dragonfly2_tpu_torch.manager import ClusterManager, ModelRegistry
from dragonfly2_tpu_torch.records.columnar import ColumnarWriter
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.rpc.grpc_transport import (
    GRPCRemoteRegistry,
    GRPCTrainerClient,
    ManagerGRPCServer,
    TrainerGRPCServer,
)
from dragonfly2_tpu_torch.rpc.scheduler_client import RPCError
from dragonfly2_tpu_torch.trainer.service import MLP_MODEL_NAME, TrainerService
from dragonfly2_tpu_torch.trainer.train import TrainConfig

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO)}


@pytest.fixture()
def cluster():
    return SyntheticCluster(num_hosts=48, seed=42)


def _wait_run(client, key, limit_s=90.0):
    deadline = time.time() + limit_s
    while True:
        status = client.run_status(key)
        if status["done"] or time.time() > deadline:
            return status
        time.sleep(0.1)


def _read_line(proc, marker, limit_s=60.0):
    deadline = time.time() + limit_s
    line = ""
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], max(deadline - time.time(), 0.1))
        if not ready:
            break
        line = proc.stdout.readline()
        if marker in line or not line:
            break
    return line


class TestTrainerCLIServe:
    def test_serve_mode_starts_both_transports(self, tmp_path):
        cfgp = tmp_path / "trainer.yaml"
        cfgp.write_text(f"data_dir: {tmp_path}/staging\n"
                        "server:\n  host: 127.0.0.1\n  port: 0\n  grpc_port: 0\n")
        p = subprocess.Popen(
            [sys.executable, "-m", "dragonfly2_tpu_torch.cli.trainer", "--config", str(cfgp),
             "--console", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=ENV)
        try:
            line = _read_line(p, "ingest on")
            assert "ingest on" in line and "grpc on" in line, line
            http_url = line.split("ingest on ")[1].split()[0]
            grpc_target = line.split("grpc on ")[1].split(",")[0]
            req = urllib.request.Request(
                http_url + "/train/open",
                data=json.dumps({"ip": "1.2.3.4", "hostname": "s",
                                 "scheduler_id": "s"}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=5) as r:
                assert json.loads(r.read())["session"]
            client = GRPCTrainerClient(grpc_target)
            with pytest.raises(RPCError, match="NOT_FOUND"):
                client.run_status("nonexistent")
            client.close()
        finally:
            p.kill()
            p.wait()


class TestManagerGRPC:
    def test_model_lifecycle_over_grpc(self):
        server = ManagerGRPCServer(ModelRegistry(), ClusterManager())
        server.serve()
        try:
            client = GRPCRemoteRegistry(server.target)
            m = client.create_model(name="gnn", type="gnn", scheduler_id="s1",
                                    artifact=b"npz-bytes", evaluation={"mae": 0.5})
            assert m.version == 1 and m.state.value == "inactive"
            m2 = client.create_model(name="gnn", type="gnn", scheduler_id="s1", artifact=b"v2")
            assert m2.version == 2
            client.activate(m.id)
            assert client.active_model("s1", "gnn").id == m.id
            client.activate(m2.id)
            assert client.active_model("s1", "gnn").id == m2.id
            assert client.get(m.id).state.value == "inactive"
            assert client.load_artifact(m2) == b"v2"
            assert len(client.list(scheduler_id="s1")) == 2
            assert client.get("ghost") is None
            assert client.active_model("s1", "nope") is None
            # No cluster CA given: the reference's answer with ca=None.
            with pytest.raises(KeyError, match="no cluster CA"):
                client.issue_certificate(b"csr")
            client.close()
        finally:
            server.stop()

    def test_keepalive_and_scheduler_listing(self):
        server = ManagerGRPCServer(ModelRegistry(), ClusterManager(keepalive_ttl=0.3))
        server.serve()
        try:
            client = GRPCRemoteRegistry(server.target)
            client.register_scheduler(id="sched-g", cluster_id="c1", ip="10.0.0.1", port=8002)
            assert [s["id"] for s in client.list_schedulers()] == ["sched-g"]
            assert client.keepalive("sched-g") is True
            assert client.keepalive("ghost") is False
            time.sleep(0.4)
            assert client.list_schedulers() == []
            client.close()
        finally:
            server.stop()

    @pytest.mark.parametrize("arg", ["token_verifier", "users", "ca", "server_credentials"])
    def test_rbac_ca_and_tls_arguments_name_item_14(self, arg):
        """Each argument takes effect as in the reference: a verifier or a
        user store refuses an anonymous mutation, a CA signs a CSR, server
        credentials serve TLS (a plaintext channel cannot call)."""
        from dragonfly2_tpu_torch.manager import UserStore
        from dragonfly2_tpu_torch.rpc import grpc_transport as gt
        from dragonfly2_tpu_torch.security import CertificateAuthority, PeerIdentity
        from dragonfly2_tpu_torch.security.tokens import TokenVerifier

        ca = CertificateAuthority()
        ident = PeerIdentity.issue(ca, common_name="m", hostnames=["localhost"],
                                   ips=["127.0.0.1"])
        value = {
            "token_verifier": TokenVerifier(b"grpc-arg-secret-0123456789"),
            "users": UserStore(),
            "ca": ca,
            "server_credentials": gt.grpc.ssl_server_credentials(
                [(ident.key_pem, ident.cert_pem)]),
        }[arg]
        server = ManagerGRPCServer(ModelRegistry(), ClusterManager(), **{arg: value})
        server.serve()
        try:
            if arg == "server_credentials":
                plain = GRPCRemoteRegistry(server.target, timeout=2)
                with pytest.raises((RPCError, ConnectionError, OSError)):
                    plain.list()
                plain.close()
                client = GRPCRemoteRegistry(
                    server.target,
                    channel_credentials=gt.grpc.ssl_channel_credentials(ca.cert_pem))
                assert client.list() == []
                client.close()
                return
            client = GRPCRemoteRegistry(server.target)
            if arg == "ca":
                from cryptography import x509
                from cryptography.hazmat.primitives import hashes, serialization
                from cryptography.hazmat.primitives.asymmetric import ec
                from cryptography.x509.oid import NameOID

                csr = (x509.CertificateSigningRequestBuilder()
                       .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "s")]))
                       .sign(ec.generate_private_key(ec.SECP256R1()), hashes.SHA256()))
                cert_pem, ca_pem = client.issue_certificate(
                    csr.public_bytes(serialization.Encoding.PEM))
                assert ca_pem == ca.cert_pem and b"BEGIN CERTIFICATE" in cert_pem
            else:
                with pytest.raises(RPCError, match="PERMISSION_DENIED"):
                    client.create_model(name="m", type="mlp", scheduler_id="s")
                assert client.list() == []  # reads stay open
            client.close()
        finally:
            server.stop()

    def test_jax_registry_client_against_the_ports_manager(self):
        """Either package's client talks to either package's server: the
        JAX ``GRPCRemoteRegistry`` drives the port's ``ManagerGRPCServer``."""
        from dragonfly2_tpu.rpc.grpc_transport import GRPCRemoteRegistry as JRegistry

        registry = ModelRegistry()
        server = ManagerGRPCServer(registry, ClusterManager())
        server.serve()
        try:
            client = JRegistry(server.target)
            m = client.create_model(name="mlp", type="mlp", scheduler_id="s",
                                    artifact=b"blob", evaluation={"mae": 1.5})
            client.activate(m.id)
            assert registry.active_model("s", "mlp").id == m.id
            assert client.load_artifact(m) == b"blob"
            assert client.active_model("s", "mlp").evaluation == {"mae": 1.5}
            client.close()
        finally:
            server.stop()


class TestFullGRPCLoop:
    def test_four_process_architecture_over_grpc(self, tmp_path, cluster):
        """records → train → registry → activation → evaluator with every
        control-plane arrow on gRPC: the port's manager, scheduler and
        trainer in their own processes, the trainer on the CPU."""
        from test_torch_grpc import PIECE, GRPCNode, WireOrigin

        procs = []

        def spawn(code, *argv):
            proc = subprocess.Popen([sys.executable, "-c", code, *argv],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=ENV)
            procs.append(proc)
            line = _read_line(proc, "READY", 60.0).strip()
            assert line.startswith("READY"), (
                line, proc.stderr.read()[:500] if proc.poll() is not None else "")
            return line.split()[1]

        manager_code = (
            "import sys, time\n"
            "from dragonfly2_tpu_torch.manager import ClusterManager, ModelRegistry\n"
            "from dragonfly2_tpu_torch.manager.registry import BlobStore\n"
            "from dragonfly2_tpu_torch.rpc.grpc_transport import ManagerGRPCServer\n"
            "reg = ModelRegistry(BlobStore(sys.argv[1]), db_path=sys.argv[1]+'/m.db')\n"
            "srv = ManagerGRPCServer(reg, ClusterManager())\n"
            "srv.serve(); print('READY', srv.target, flush=True); time.sleep(180)\n"
        )
        scheduler_code = (
            "import sys, time\n"
            "from dragonfly2_tpu_torch.records.storage import Storage\n"
            "from dragonfly2_tpu_torch.rpc.grpc_transport import SchedulerGRPCServer\n"
            "from dragonfly2_tpu_torch.scheduler import Evaluator, Resource, SchedulerService,"
            " Scheduling, SchedulingConfig\n"
            "svc = SchedulerService(Resource(), Scheduling(Evaluator(),"
            " SchedulingConfig(retry_interval=0)), Storage(sys.argv[1], buffer_size=1))\n"
            "srv = SchedulerGRPCServer(svc)\n"
            "srv.serve(); print('READY', srv.target, flush=True); time.sleep(180)\n"
        )
        trainer_code = (
            "import sys, time\n"
            "from dragonfly2_tpu_torch.rpc.grpc_transport import GRPCRemoteRegistry,"
            " TrainerGRPCServer\n"
            "from dragonfly2_tpu_torch.trainer.service import TrainerService\n"
            "from dragonfly2_tpu_torch.trainer.train import TrainConfig\n"
            "svc = TrainerService(GRPCRemoteRegistry(sys.argv[1]), data_dir=sys.argv[2],\n"
            "    train_config=TrainConfig(epochs=2, learning_rate=3e-3, warmup_steps=10),\n"
            "    mlp_epochs=4, device='cpu')\n"
            "srv = TrainerGRPCServer(svc)\n"
            "srv.serve(); print('READY', srv.target, flush=True); time.sleep(300)\n"
        )
        try:
            mtarget = spawn(manager_code, str(tmp_path / "manager"))
            starget = spawn(scheduler_code, str(tmp_path / "records"))
            ttarget = spawn(trainer_code, mtarget, str(tmp_path / "staged"))
            origin = WireOrigin()
            nodes = [GRPCNode(i, starget, tmp_path, origin) for i in range(3)]
            url = "https://origin/grpc-wire-a"
            assert nodes[0].conductor.download(url, piece_size=PIECE,
                                               content_length=4 * PIECE).ok
            for i in (1, 2):
                r = nodes[i].conductor.download(url, piece_size=PIECE)
                assert r.ok and not r.back_to_source
            shard = tmp_path / "synth.dfc"
            with ColumnarWriter(str(shard), DOWNLOAD_COLUMNS) as w:
                w.append(cluster.generate_feature_rows(2000, seed=11))
            tclient = GRPCTrainerClient(ttarget, timeout=300)
            key = tclient.train(ip="10.0.0.1", hostname="sched", scheduler_id="sched-grpc",
                                download_shards=[str(shard)])
            status = _wait_run(tclient, key)
            assert status["done"] and not status["error"], status
            from dragonfly2_tpu_torch.scheduler import MLEvaluator, ModelSubscriber

            registry = GRPCRemoteRegistry(mtarget)
            models = registry.list(scheduler_id="sched-grpc", name=MLP_MODEL_NAME)
            assert len(models) == 1
            registry.activate(models[0].id)
            ev = MLEvaluator()
            assert ModelSubscriber(registry, ev, scheduler_id="sched-grpc").refresh() is True
            assert ev.has_model
            for n in nodes:
                n.stop()
            tclient.close()
            registry.close()
        finally:
            for p in procs:
                p.terminate()
                p.wait()


class TestTrainerGRPC:
    def test_train_stream_end_to_end(self, tmp_path, cluster):
        registry = ModelRegistry()
        service = TrainerService(registry, data_dir=str(tmp_path / "staged"),
                                 train_config=TrainConfig(epochs=2, warmup_steps=5),
                                 mlp_epochs=4, device="cpu")
        server = TrainerGRPCServer(service)
        server.serve()
        try:
            shard = tmp_path / "download.dfc"
            with ColumnarWriter(str(shard), DOWNLOAD_COLUMNS) as w:
                w.append(cluster.generate_feature_rows(1500, seed=3))
            client = GRPCTrainerClient(server.target)
            key = client.train(ip="10.0.0.9", hostname="sched-9", scheduler_id="sched-9",
                               download_shards=[str(shard)])
            status = _wait_run(client, key)
            assert status["done"] and not status["error"], status
            assert status["download_rows"] == 1500 and status["models"]
            assert registry.list(scheduler_id="sched-9", name=MLP_MODEL_NAME)
            client.close()
        finally:
            server.stop()

    def test_chunked_stream_reassembles(self, tmp_path, cluster):
        import glob

        service = TrainerService(data_dir=str(tmp_path / "staged"),
                                 train_config=TrainConfig(epochs=1, warmup_steps=1),
                                 mlp_epochs=1, device="cpu")
        server = TrainerGRPCServer(service)
        server.serve()
        try:
            shard = tmp_path / "big.dfc"
            with ColumnarWriter(str(shard), DOWNLOAD_COLUMNS) as w:
                w.append(cluster.generate_feature_rows(4000, seed=4))
            client = GRPCTrainerClient(server.target)
            client.CHUNK_BYTES = 64 * 1024
            key = client.train(ip="1.2.3.4", hostname="s", scheduler_id="s",
                               download_shards=[str(shard)])
            assert _wait_run(client, key)["done"]
            staged = glob.glob(str(tmp_path / "staged" / "*" / "download_big.dfc"))[0]
            with open(staged, "rb") as a, open(shard, "rb") as b:
                assert a.read() == b.read()
            client.close()
        finally:
            server.stop()


# -- the binaries on a machine without grpc ------------------------------------


def _no_grpc_path(tmp_path) -> str:
    """A directory whose ``grpc`` module fails to import, first on the path:
    the binaries then see a machine without the package."""
    stub = tmp_path / "nogrpc"
    stub.mkdir()
    (stub / "grpc.py").write_text(
        "raise ModuleNotFoundError(\"No module named 'grpc'\", name='grpc')\n")
    return f"{stub}{os.pathsep}{REPO}"


@pytest.mark.parametrize("binary,argv,env", [
    ("scheduler", ["--device", "cpu"], {"DRAGONFLY_SCHEDULER_SERVER_GRPC_PORT": "0"}),
    ("scheduler", ["--device", "cpu"], {"DRAGONFLY_SCHEDULER_TRAINER_ENABLE": "true",
                                        "DRAGONFLY_SCHEDULER_TRAINER_ADDR": "grpc://t:9090"}),
    ("trainer", ["--device", "cpu"], {"DRAGONFLY_TRAINER_SERVER_GRPC_PORT": "0"}),
    ("trainer", ["--device", "cpu", "--manager", "grpc://m:65003"], {}),
    ("manager", [], {"DRAGONFLY_MANAGER_SERVER_GRPC_PORT": "0"}),
    ("dfdaemon", ["--scheduler", "grpc://127.0.0.1:9"], {}),
])
def test_grpc_settings_exit_2_naming_the_missing_package(tmp_path, binary, argv, env):
    base = {**ENV, "PYTHONPATH": _no_grpc_path(tmp_path),
            "DRAGONFLY_SCHEDULER_STORAGE_DIR": str(tmp_path / "records"),
            "DRAGONFLY_SCHEDULER_METRICS_ENABLE": "false",
            "DRAGONFLY_DAEMON_METRICS_ENABLE": "false",
            "DRAGONFLY_TRAINER_DATA_DIR": str(tmp_path / "staged"),
            "DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR": str(tmp_path / "blobs"),
            "DRAGONFLY_MANAGER_SERVER_PORT": "0",
            "DRAGONFLY_DAEMON_SERVER_PORT": "0",
            "DRAGONFLY_DAEMON_STORAGE_DIR": str(tmp_path / "store"),
            "DF_DAEMON_STATE": str(tmp_path / "daemon.json")}
    proc = subprocess.run(
        [sys.executable, "-m", f"dragonfly2_tpu_torch.cli.{binary}", *argv],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path), env={**base, **env})
    assert proc.returncode == 2, (proc.stdout, proc.stderr)
    assert proc.stderr.startswith(f"{binary}: ") and "'grpc' is not installed" in proc.stderr
    assert "12c" not in proc.stderr
    assert not (tmp_path / "blobs").exists() and not (tmp_path / "records").exists()
