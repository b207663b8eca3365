"""The port's deployment artifacts, checked without a cluster:
``dragonfly2_tpu_torch/deploy/`` (compose file, image, configs, k8s
manifests and the offline validator) against the reference's
``deploy/``.

- compose runs the seven services, each command a module of the port;
- each config holds the reference's keys and values and loads equal in
  both packages' ``load_config``;
- the image builds from a PyTorch CUDA devel base, installs no JAX and
  copies only the port;
- the k8s manifest mirrors compose through the port's ``k8s_topology`` /
  ``compose_topology``, with the GPU limits (and compose's reservations)
  on the scheduler and the trainer only;
- the port's ``validate_documents`` gives the reference's error list on
  both manifests and on every deliberately broken variant of
  ``tests/test_deploy.py``; a validator that skips ``volumeMounts`` is
  caught;
- ``run_local`` at its default ``--device cuda`` with no card exits
  non-zero naming the card, before it starts anything.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
import yaml

from dragonfly2_tpu_torch.deploy import k8s_validate as port_v
from dragonfly2_tpu_torch.deploy import run_local

REPO = Path(__file__).resolve().parents[1]
DEPLOY = REPO / "dragonfly2_tpu_torch" / "deploy"
REF_DEPLOY = REPO / "deploy"
SERVICES = {"manager", "scheduler", "trainer", "seed", "daemon-a", "daemon-b", "e2e"}
CONFIGS = {
    "manager.yaml": "ManagerConfig",
    "scheduler.yaml": "SchedulerConfigFile",
    "trainer.yaml": "TrainerConfigFile",
    "seed.yaml": "DaemonConfig",
    "daemon.yaml": "DaemonConfig",
}
GPU_COMPONENTS = {"scheduler", "trainer"}


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_v():
    return _load_module(REF_DEPLOY / "k8s_validate.py", "ref_k8s_validate")


def _docs(path):
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d is not None]


def _compose():
    with open(DEPLOY / "docker-compose.yaml") as f:
        return yaml.safe_load(f)


# -- compose, configs, image --------------------------------------------------


def test_compose_covers_the_services_with_the_ports_modules():
    services = _compose()["services"]
    assert set(services) == SERVICES
    for name, svc in services.items():
        assert svc["image"] == "dragonfly2-tpu-torch", name
        module = svc["command"][0]
        assert module.startswith("dragonfly2_tpu_torch."), (name, module)
        __import__(module)  # the entry point exists
    assert services["e2e"]["command"] == ["dragonfly2_tpu_torch.deploy.e2e_loop"]
    assert services["manager"]["build"]["dockerfile"] == (
        "dragonfly2_tpu_torch/deploy/docker/Dockerfile")
    assert (DEPLOY / services["manager"]["build"]["context"]).resolve() == REPO


def test_compose_reserves_a_gpu_for_the_scheduler_and_trainer_only():
    for name, svc in _compose()["services"].items():
        devices = svc.get("deploy", {}).get("resources", {}).get(
            "reservations", {}).get("devices", [])
        if name in GPU_COMPONENTS:
            assert devices == [{"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}]
        else:
            assert devices == [], name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_is_the_references_and_loads_equal_in_both_packages(name):
    import dragonfly2_tpu.config as jax_config

    import dragonfly2_tpu_torch.config as port_config

    path = DEPLOY / "config" / name
    with open(path) as f, open(REF_DEPLOY / "config" / name) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    schema = CONFIGS[name]
    port = port_config.load_config(getattr(port_config, schema), str(path), env=False)
    ref = jax_config.load_config(getattr(jax_config, schema), str(path), env=False)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if name == "scheduler.yaml":
        assert port.manager_addr == "http://manager:65003"
        assert port.trainer.enable and "trainer" in port.trainer.addr


def test_run_local_json_configs_load_equal_in_both_packages(tmp_path):
    """``run_local`` writes its configs as JSON: both packages' loaders
    read them to the same config."""
    import dragonfly2_tpu.config as jax_config

    import dragonfly2_tpu_torch.config as port_config

    path = tmp_path / "scheduler.json"
    path.write_text('{"server": {"host": "127.0.0.1", "port": 0, "grpc_port": -1}, '
                    '"storage": {"dir": "/x", "buffer_size": 1}, "manager_addr": "http://m", '
                    '"security": {"auto_issue": true}}')
    got = port_config.load_config(port_config.SchedulerConfigFile, str(path), env=False)
    want = jax_config.load_config(jax_config.SchedulerConfigFile, str(path), env=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.server.port == 0 and got.storage.buffer_size == 1 and got.security.auto_issue


def test_dockerfile_devel_base_no_jax_port_only():
    text = (DEPLOY / "docker" / "Dockerfile").read_text()
    lines = [ln.strip() for ln in text.splitlines()]
    base = next(ln for ln in lines if ln.startswith("FROM "))
    assert base.startswith("FROM pytorch/pytorch:") and base.endswith("-devel"), base
    code = "\n".join(ln for ln in lines if not ln.startswith("#"))
    for name in ("jax", "flax", "optax", "orbax"):
        assert name not in code, name
    assert "pip install --no-cache-dir numpy pyyaml cryptography grpcio protobuf" in code
    copies = [ln for ln in lines if ln.startswith("COPY ")]
    assert "COPY dragonfly2_tpu_torch ./dragonfly2_tpu_torch" in copies
    assert not any(ln.startswith("COPY dragonfly2_tpu ") for ln in copies)
    assert "native.load()" in code and "_build.load()" in code
    assert 'ENTRYPOINT ["python", "-m"]' in code


# -- k8s ----------------------------------------------------------------------


def test_manifest_mirrors_compose():
    docs = _docs(DEPLOY / "k8s" / "dragonfly.yaml")
    k8s = port_v.k8s_topology(docs)
    comp = port_v.compose_topology(_compose())
    pairs = {"manager": "manager", "scheduler": "scheduler", "trainer": "trainer",
             "seed": "seed", "daemon-a": "daemon", "daemon-b": "daemon"}
    for c_name, k_name in pairs.items():
        assert comp[c_name]["module"] == k8s[k_name]["module"], (c_name, comp, k8s)
        assert comp[c_name]["module"].startswith("dragonfly2_tpu_torch.cli.")
        assert comp[c_name]["config"] == k8s[k_name]["config"], c_name
        __import__(k8s[k_name]["module"])
    assert set(comp) - set(pairs) == {"e2e"}
    assert set(k8s) == set(pairs.values())
    assert {w["image"] for w in k8s.values()} == {"dragonfly2-tpu-torch"}
    replicas = k8s["scheduler"]["replicas"]
    assert replicas == 2
    for wl in ("seed", "daemon"):
        doc = next(d for d in docs if d["metadata"]["name"] == wl
                   and d["kind"] in ("Deployment", "DaemonSet"))
        cmd = doc["spec"]["template"]["spec"]["containers"][0]["command"]
        assert set(cmd[cmd.index("--scheduler") + 1].split(",")) == {
            f"http://scheduler-{i}.scheduler:8002" for i in range(replicas)}
    cfg = {}
    for name in ("manager", "scheduler", "trainer", "daemon", "seed"):
        with open(DEPLOY / "config" / f"{name}.yaml") as f:
            cfg[name] = yaml.safe_load(f)
    for comp_name in ("manager", "scheduler", "trainer"):
        assert cfg[comp_name]["server"]["port"] in k8s[comp_name]["ports"], comp_name
    assert cfg["daemon"]["server"]["port"] in k8s["daemon"]["ports"]
    assert cfg["daemon"]["control_port"] in k8s["daemon"]["ports"]
    assert cfg["seed"]["server"]["port"] in k8s["seed"]["ports"]
    for doc in docs:
        if doc["kind"] == "Service":
            bind = cfg[doc["metadata"]["name"]]["server"]["port"]
            for port in doc["spec"]["ports"]:
                assert port["port"] == bind and port.get("targetPort", bind) == bind


def test_reference_compose_topology_sees_no_port_module(ref_v):
    """The reference's ``compose_topology`` keys on ``dragonfly2_tpu.``: it
    finds no module in the port's compose file, the port's finds all."""
    comp = _compose()
    assert {s["module"] for s in ref_v.compose_topology(comp).values()} == {None}
    assert None not in {s["module"] for s in port_v.compose_topology(comp).values()}


def test_gpu_limits_on_the_scheduler_and_trainer_only():
    seen = set()
    for doc in _docs(DEPLOY / "k8s" / "dragonfly.yaml"):
        if doc["kind"] not in port_v.WORKLOAD_KINDS:
            continue
        name = doc["metadata"]["name"]
        resources = doc["spec"]["template"]["spec"]["containers"][0].get("resources")
        if name in GPU_COMPONENTS:
            assert resources == {"limits": {"nvidia.com/gpu": 1}}, name
            seen.add(name)
        else:
            assert resources is None, name
    assert seen == GPU_COMPONENTS


def _deployment(docs, name):
    return next(d for d in docs if d["kind"] == "Deployment" and d["metadata"]["name"] == name)


def _service(docs, name):
    return next(d for d in docs if d["kind"] == "Service" and d["metadata"]["name"] == name)


def _misnest(docs):
    dep = _deployment(docs, "manager")
    dep["spec"]["containers"] = dep["spec"]["template"]["spec"].pop("containers")


def _typo(docs):
    dep = _deployment(docs, "seed")
    dep["spec"]["replica"] = dep["spec"].pop("replicas")


def _ds_replicas(docs):
    next(d for d in docs if d["kind"] == "DaemonSet")["spec"]["replicas"] = 3


def _bad_qty(docs):
    ss = next(d for d in docs if d["kind"] == "StatefulSet")
    ss["spec"]["volumeClaimTemplates"][0]["spec"]["resources"]["requests"]["storage"] = "one-gig"


def _bad_cm(docs):
    docs.append({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm"},
                 "data": {"daemon.yaml": {"server": {"port": 65000}}}})


def _container(docs, name):
    return _deployment(docs, name)["spec"]["template"]["spec"]["containers"][0]


# tests/test_deploy.py's broken variants: (id, mutation, what an error says).
BROKEN = [
    ("beta-api", lambda d: _deployment(d, "manager").__setitem__("apiVersion", "apps/v1beta1"),
     "apiVersion"),
    ("misnest", _misnest, "unknown field 'containers'"),
    ("port-range", lambda d: _container(d, "trainer")["ports"][0].__setitem__(
        "containerPort", 99_090), "port"),
    ("port-type", lambda d: _service(d, "manager")["spec"]["ports"][0].__setitem__(
        "port", "65003"), "port"),
    ("selector", lambda d: _deployment(d, "manager")["spec"]["selector"][
        "matchLabels"].__setitem__("component", "managr"), "select"),
    ("dangling-mount", lambda d: _container(d, "manager")["volumeMounts"][0].__setitem__(
        "name", "cfg"), "mounts volume"),
    ("typo", _typo, "unknown field 'replica'"),
    ("daemonset-replicas", _ds_replicas, "DaemonSet has no replicas"),
    ("quantity", _bad_qty, "quantity"),
    ("update-strategy", lambda d: _deployment(d, "manager")["spec"].__setitem__(
        "updateStrategy", {"type": "Recreate"}), "unknown field 'updateStrategy'"),
    ("configmap", _bad_cm, "string→string map"),
    ("selector-string", lambda d: _service(d, "manager")["spec"].__setitem__(
        "selector", "manager"), "string→string map"),
    ("selects-nothing", lambda d: _service(d, "manager")["spec"]["selector"].__setitem__(
        "component", "nothing"), "selects no workload"),
]
MANIFESTS = {"port": DEPLOY / "k8s" / "dragonfly.yaml",
             "reference": REF_DEPLOY / "k8s" / "dragonfly.yaml"}


@pytest.mark.parametrize("manifest", sorted(MANIFESTS))
def test_validator_equals_the_references_on_the_manifests(ref_v, manifest):
    docs = _docs(MANIFESTS[manifest])
    assert port_v.validate_documents(copy.deepcopy(docs)) == ref_v.validate_documents(docs) == []


@pytest.mark.parametrize("manifest", sorted(MANIFESTS))
@pytest.mark.parametrize("case", BROKEN, ids=[c[0] for c in BROKEN])
def test_validator_equals_the_references_on_broken_variants(ref_v, manifest, case):
    _, mutate, needle = case
    docs = _docs(MANIFESTS[manifest])
    mutate(docs)
    want = ref_v.validate_documents(copy.deepcopy(docs))
    got = port_v.validate_documents(docs)
    assert got == want
    assert any(needle in e for e in got), got


def test_validator_that_skips_volume_mounts_is_caught(ref_v):
    source = Path(port_v.__file__).read_text()
    loop = 'for i, m in enumerate(c.get("volumeMounts", [])):'
    assert loop in source
    mutant = types.ModuleType("k8s_validate_mutant")
    mutant.__file__ = port_v.__file__
    exec(compile(source.replace(loop, "for i, m in enumerate([]):"), "mutant", "exec"),
         mutant.__dict__)
    docs = _docs(MANIFESTS["port"])
    _container(docs, "manager")["volumeMounts"][0]["name"] = "cfg"
    want = ref_v.validate_documents(copy.deepcopy(docs))
    assert any("mounts volume" in e for e in want)
    assert mutant.validate_documents(docs) != want


def test_validator_cli_on_the_ports_manifest():
    proc = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.deploy.k8s_validate"],
        capture_output=True, text=True, timeout=60, cwd=str(REPO / "tests"),
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0 and "structurally valid" in proc.stdout, proc.stderr


# -- run_local ----------------------------------------------------------------


@pytest.mark.parametrize("argv,replicas", [([], 1), (["--replicas"], 2),
                                           (["--replicas", "3"], 3),
                                           (["--replicas", "--mtls"], 2),
                                           (["--replicas", "0"], 1)])
def test_run_local_arguments(argv, replicas):
    args = run_local.parse_args(argv)
    assert args.replicas == replicas and args.device == "cuda"
    assert args.mtls == ("--mtls" in argv) and not args.manager_standby


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is visible")
def test_run_local_without_a_card_exits_naming_it():
    proc = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.deploy.run_local"],
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr and "--device cpu" in proc.stderr, proc.stderr
    assert "run_local:" in proc.stderr and proc.stdout == ""


@pytest.mark.parametrize("device", ["bogus", "cuda:x", "meta"])
def test_run_local_names_a_bad_device_string_as_such(device):
    # Only a CUDA device with no card is reported as a missing card.
    with pytest.raises(SystemExit) as exc:
        run_local.check_device(device)
    assert f"--device {device}:" in str(exc.value)
    assert "no CUDA card" not in str(exc.value)


# The serve path of each binary that runs nothing on the card, in a fresh
# interpreter: the manager served and stopped, a daemon built.
_NO_CARD_PATHS = {
    "manager": (
        "from dragonfly2_tpu_torch.cli import manager\n"
        "from dragonfly2_tpu_torch.config.schema import ManagerConfig\n"
        "cfg = ManagerConfig()\n"
        "cfg.server.port = 0\n"
        "cfg.registry.blob_dir = tempfile.mkdtemp()\n"
        "manager.serve(cfg).stop()\n"
    ),
    "dfdaemon": (
        "from dragonfly2_tpu_torch.cli import dfdaemon\n"
        "from dragonfly2_tpu_torch.config.schema import DaemonConfig\n"
        "cfg = DaemonConfig()\n"
        "cfg.server.port = 0\n"
        "cfg.server.advertise_ip = '127.0.0.1'\n"
        "cfg.storage.dir = tempfile.mkdtemp()\n"
        "dfdaemon.build(cfg, 'http://127.0.0.1:1', prefer_native=False)\n"
    ),
}


@pytest.mark.parametrize("binary", sorted(_NO_CARD_PATHS))
def test_binaries_that_run_nothing_on_the_card_import_no_torch(binary, tmp_path):
    # Four of the cluster's six binaries: importing torch would add its
    # seconds to each of their boots (8-15 s on an H100 host).
    code = ("import sys, tempfile\n" + _NO_CARD_PATHS[binary]
            + "print('torch' in sys.modules, 'dragonfly2_tpu_torch.ops' in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "TMPDIR": str(tmp_path),
           "DF_DAEMON_STATE": str(tmp_path / "daemon.json")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-2:] == ["False", "False"], proc.stdout


def test_run_local_takes_the_cpu():
    run_local.check_device("cpu")
