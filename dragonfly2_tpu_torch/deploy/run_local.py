"""Bring up the port's whole cluster as OS processes and run its e2e loop:
the docker-compose topology without containers (CI and dev machines
without a docker daemon; the container path is ``docker-compose.yaml``
beside this file, with the SAME services and the SAME ``e2e_loop``).

  python -m dragonfly2_tpu_torch.deploy.run_local
      [--device cuda|cpu]   # the scheduler's and the trainer's device
                            # (cuda, the binaries' default: no card exits
                            # 1 naming it before anything starts)
      [--mtls]              # auto-issued mTLS on the piece plane
                            # (manager-hosted CA)
      [--replicas [N]]      # N scheduler replicas (bare: 2): daemons
                            # steer tasks by consistent hash, the probe
                            # graph is shared through the manager
      [--manager-standby]   # a leader + hot-standby manager pair

Exit 0 = cluster up and every stage of the loop passed.

Port of ``deploy/run_local.py``: the pump thread, the ready-line
regexes, the HA secret, the per-replica storage, the ephemeral origin
port and the SIGTERM teardown as there.  It spawns
``dragonfly2_tpu_torch.cli.*``, passes ``--device`` to the scheduler and
the trainer (the two binaries that take it), sets no JAX variable, and
writes each service's config as JSON (a subset of YAML).  The binaries
start in three waves, the binaries of a wave together: the manager (then
its standby), the trainer and the schedulers, the seed and the two
daemons.  ``cluster`` brings the cluster up and hands back the e2e
environment; ``main`` runs the port's ``e2e_loop`` through it, and any
e2e script that reads the same variables can run through it too.  Each
service's boot prints its seconds from its own start (``run_local: NAME
up in S s``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import re
import secrets
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional

# The directory holding the package: the children's PYTHONPATH.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PIECE = 64 * 1024
READY_S = 60.0  # each service's ready line must come within this
# A binary's last line (cli/common.report_launches).
LAUNCHES_LINE = re.compile(r"^\S+: kernel launches (\{.*\})$")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m dragonfly2_tpu_torch.deploy.run_local",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the scheduler and the trainer (cuda or cpu)")
    p.add_argument("--mtls", action="store_true",
                   help="auto-issued mTLS on the piece plane")
    # Value optional: bare "--replicas" means 2.
    p.add_argument("--replicas", type=int, nargs="?", const=2, default=1, metavar="N",
                   help="scheduler replicas (bare: 2)")
    p.add_argument("--manager-standby", action="store_true",
                   help="a leader + hot-standby manager pair")
    args = p.parse_args(argv)
    args.replicas = max(args.replicas, 1)
    return args


def check_device(device: str) -> None:
    """Refuse a CUDA device with no card before anything starts: the
    cluster never trains quietly on the CPU."""
    import torch

    from ..ops._build import resolve_device

    try:
        torch.device(device)
    except RuntimeError as exc:  # not a device string at all
        raise SystemExit(f"run_local: --device {device}: {exc}") from None
    try:
        resolve_device(device)
    except RuntimeError:  # a CUDA device with no card
        raise SystemExit(
            f"run_local: --device {device} but no CUDA card is visible "
            "(torch.cuda.is_available() is False); pass --device cpu to run "
            "the cluster on the CPU"
        ) from None
    except ValueError as exc:
        raise SystemExit(f"run_local: --device {device}: {exc}") from None


@contextlib.contextmanager
def cluster(
    *,
    device: str = "cuda",
    mtls: bool = False,
    replicas: int = 1,
    manager_standby: bool = False,
) -> Iterator[Dict[str, str]]:
    """Manager (or, with ``manager_standby``, a leader and its hot
    standby), trainer, ``replicas`` schedulers, a seed daemon and two
    daemons, each a child process on loopback with an ephemeral port;
    yields the e2e loop's environment (the services' URLs, an ephemeral
    origin address, ``TRAINER_DEVICE``).  On exit every child gets
    SIGTERM (SIGKILL after 5 s), each child's kernel-launch line is
    echoed (``run_local: NAME kernel launches {...}``), and the scratch
    directory goes."""
    check_device(device)
    tmp = tempfile.mkdtemp(prefix="df-local-")
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs: List[subprocess.Popen] = []
    pumps: List[tuple] = []  # (name, its line queue, its pump thread)

    os.makedirs(os.path.join(tmp, "config"))

    def write(name: str, config: dict) -> str:
        path = os.path.join(tmp, "config", name)
        with open(path, "w") as f:
            json.dump(config, f)
        return path

    def start(name, argv, extra_env=None):
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**env, **(extra_env or {})},
        )
        procs.append(proc)
        # A reader THREAD owns the pipe: mixing select() on the fd with
        # buffered readline() can strand a ready line in the Python-side
        # buffer (stderr is merged, so log lines coalesce with it in one
        # OS read) and falsely declare the service dead.
        #
        # Bounded: after readiness nobody consumes — the pump drops the
        # oldest instead of retaining every log line for the cluster's
        # lifetime, and keeps reading so the child never blocks on a
        # full pipe.
        lines: "queue.Queue" = queue.Queue(maxsize=1000)

        def pump() -> None:
            for raw in proc.stdout:
                while True:
                    try:
                        lines.put_nowait(raw)
                        break
                    except queue.Full:
                        try:
                            lines.get_nowait()
                        except queue.Empty:
                            pass

        thread = threading.Thread(target=pump, name=f"pump-{name}", daemon=True)
        thread.start()
        pumps.append((name, lines, thread))
        return name, t0, lines

    def ready(started, ready_prefixes):
        name, t0, lines = started
        found = {}
        deadline = t0 + READY_S
        while time.perf_counter() < deadline and len(found) < len(ready_prefixes):
            try:
                line = lines.get(timeout=max(deadline - time.perf_counter(), 0.1)).strip()
            except queue.Empty:
                break
            for p in ready_prefixes:
                if line.startswith(p):
                    found[p] = line
        if len(found) != len(ready_prefixes):
            raise SystemExit(f"run_local: {name} never became ready ({found})")
        print(f"run_local: {name} up in {time.perf_counter() - t0:.3f} s", flush=True)
        return found

    def spawn(name, argv, ready_prefixes, extra_env=None):
        return ready(start(name, argv, extra_env), ready_prefixes)

    server = {"host": "127.0.0.1", "port": 0, "grpc_port": -1}
    try:
        # The HA pair shares a generated lease secret (config validation
        # refuses the public default — it would let anyone forge leases
        # or fetch the replicated state).
        ha = {"enable": True, "lease_ttl_s": 5.0, "lease_secret": secrets.token_hex(16)}
        mconfig = {"server": server, "registry": {"blob_dir": f"{tmp}/manager"}}
        if manager_standby:
            mconfig["ha"] = ha
        if mtls:
            mconfig["ca_dir"] = f"{tmp}/ca"
        mcfg = write("manager.json", mconfig)
        mout = spawn("manager", ["dragonfly2_tpu_torch.cli.manager", "--config", mcfg],
                     ["manager: serving"])
        manager_url = re.search(r"REST on (\S+)", mout["manager: serving"]).group(1)
        manager_urls = manager_url
        if manager_standby:
            sbmcfg = write("manager-standby.json", {
                "server": server, "registry": {"blob_dir": f"{tmp}/manager-standby"},
                "ha": ha,
            })
            sbout = spawn(
                "manager-standby",
                ["dragonfly2_tpu_torch.cli.manager", "--config", sbmcfg,
                 "--replicate-from", manager_url],
                ["manager: serving"],
            )
            standby_url = re.search(
                r"REST on (\S+)", sbout["manager: serving"]
            ).group(1)
            # Every manager client takes the pair: comma-separated spec
            # feeds rpc/resolver.ManagerEndpoints.
            manager_urls = f"{manager_url},{standby_url}"

        # The trainer and the schedulers need only the manager, the
        # daemons only the schedulers: each wave's binaries start
        # together (each imports torch for seconds) and are then waited
        # for in order.
        tcfg = write("trainer.json", {
            "server": server, "data_dir": f"{tmp}/trainer",
            "training": {"epochs": 6, "learning_rate": 0.003, "warmup_steps": 10},
        })
        trainer = start("trainer",
                        ["dragonfly2_tpu_torch.cli.trainer", "--config", tcfg,
                         "--manager", manager_url, "--device", device])

        def scheduler_config(records: str, sync_s: float) -> dict:
            config = {
                "server": server,
                "scheduling": {"retry_interval_s": 0.1},
                "storage": {"dir": records, "buffer_size": 1},
                "manager_addr": manager_urls,
                "dynconfig_refresh_s": 5.0,
                "topology_sync_interval_s": sync_s,
            }
            if mtls:
                config["security"] = {"auto_issue": True}
            return config

        schedulers = []
        for n in range(replicas):
            # Replica N: same manager, own storage — the probe graph
            # crosses replicas only through the manager's topology sync.
            suffix = f"-{n}" if n else ""
            scfg = write(f"scheduler{suffix}.json", scheduler_config(
                f"{tmp}/records{suffix}", 3.0 if replicas > 1 else 10.0))
            schedulers.append(start(f"scheduler{suffix}",
                                    ["dragonfly2_tpu_torch.cli.scheduler", "--config", scfg,
                                     "--device", device]))
        tout = ready(trainer, ["trainer: ingest"])
        trainer_url = re.search(r"ingest on (\S+?)[, ]",
                                tout["trainer: ingest"] + " ").group(1)
        scheduler_url, *replica_urls = [
            re.search(r"rpc on (\S+?),", ready(sch, ["scheduler: serving"])
                      ["scheduler: serving"] + ",").group(1)
            for sch in schedulers
        ]
        scheduler_b_url = replica_urls[0] if replica_urls else ""

        # Auto-issued mTLS: every daemon bootstraps its identity from the
        # manager's cluster CA at boot; the piece plane then moves bytes
        # over mutual TLS end to end (certify analog).
        def daemon_config(store: str) -> dict:
            config = {
                "server": {"host": "127.0.0.1", "port": 0, "advertise_ip": "127.0.0.1"},
                "storage": {"dir": store},
                "piece_size": PIECE,
            }
            if mtls:
                config.update(manager_addr=manager_url, security={"auto_issue": True})
            return config

        seedcfg = write("seed.json", daemon_config(f"{tmp}/seed"))
        daemon_scheduler_arg = ",".join([scheduler_url] + replica_urls)
        daemons = [start("seed",
                         ["dragonfly2_tpu_torch.cli.dfdaemon", "--scheduler",
                          daemon_scheduler_arg, "--config", seedcfg, "--seed-peer"],
                         {"DF_DAEMON_STATE": f"{tmp}/seed.json"})]
        for name in ("daemon-a", "daemon-b"):
            dcfg = write(f"{name}.json", daemon_config(f"{tmp}/{name}"))
            daemons.append(start(name,
                                 ["dragonfly2_tpu_torch.cli.dfdaemon", "--scheduler",
                                  daemon_scheduler_arg, "--config", dcfg],
                                 {"DF_DAEMON_STATE": f"{tmp}/{name}.json"}))
        controls = {}
        for started in daemons:
            dout = ready(started, ["dfdaemon: serving"])
            controls[started[0]] = re.search(
                r"control (\S+?)[, ]", dout["dfdaemon: serving"] + " "
            ).group(1)

        print("run_local: cluster up, running e2e loop", flush=True)
        # Ephemeral origin port: concurrent runs on one machine (CI + a
        # dev shell) must not collide on a fixed port.
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        origin_port = probe.getsockname()[1]
        probe.close()
        yield {
            **env,
            "MANAGER_URL": manager_url,
            "MANAGER_URLS": manager_urls,
            "SCHEDULER_URL": scheduler_url,
            "SCHEDULER_B_URL": scheduler_b_url,
            "TRAINER_URL": trainer_url,
            "TRAINER_DEVICE": device,
            "DAEMON_A_CONTROL": controls["daemon-a"],
            "DAEMON_B_CONTROL": controls["daemon-b"],
            "ORIGIN_BIND": f"127.0.0.1:{origin_port}",
            "ORIGIN_URL": f"http://127.0.0.1:{origin_port}",
        }
    finally:
        for p in procs:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.time() + 5
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
        # Each binary's last line counts its own kernel launches: the
        # pumps have read it by the time their child's pipe closes.
        for name, lines, thread in pumps:
            thread.join(timeout=5)
            while True:
                try:
                    line = lines.get_nowait().strip()
                except queue.Empty:
                    break
                count = LAUNCHES_LINE.match(line)
                if count:
                    print(f"run_local: {name} kernel launches {count[1]}", flush=True)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    with cluster(device=args.device, mtls=args.mtls, replicas=args.replicas,
                 manager_standby=args.manager_standby) as e2e_env:
        rc = subprocess.call(
            [sys.executable, "-m", "dragonfly2_tpu_torch.deploy.e2e_loop"], env=e2e_env,
        )
    print(f"run_local: e2e exit {rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
