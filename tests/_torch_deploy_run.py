"""The port's one-command cluster as a child process, for the cluster
test files (one cluster a file, so ``--dist loadfile`` spreads them)."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# The cluster files run side by side: one intra-op thread a torch process
# keeps the trainer's round from fighting the other clusters' for cores.
ENV = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def run_local(*argv: str, timeout: float = 300.0) -> subprocess.CompletedProcess:
    """``run_local --device cpu ARGV`` to its end → the completed process.
    It runs in a session of its own: past ``timeout`` the whole cluster is
    killed with it, not only ``run_local``."""
    cmd = [sys.executable, "-m", "dragonfly2_tpu_torch.deploy.run_local", "--device", "cpu",
           *argv]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=ENV, cwd=str(REPO), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"run_local timed out after {timeout} s:\n{out[-3000:]}") from None
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def check_passed(r: subprocess.CompletedProcess, services) -> None:
    """Exit 0, every stage passed, every service booted once, the
    trainer's round trained on the CPU, and every service's binary
    reported its kernel launches as it stopped: none.  The trainer and
    the schedulers import the kernel wrappers (they run on ``--device``)
    and count each kernel; the manager and the daemons never import
    them and report ``{}``."""
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert "ALL STAGES PASSED" in r.stdout
    booted = [ln.split()[1] for ln in r.stdout.splitlines()
              if ln.startswith("run_local: ") and " up in " in ln]
    assert booted == list(services), booted
    assert "finished on cpu in " in r.stdout
    assert "run_local: e2e exit 0" in r.stdout
    launches = {ln.split()[1]: json.loads(ln.split(" kernel launches ", 1)[1])
                for ln in r.stdout.splitlines()
                if ln.startswith("run_local: ") and " kernel launches " in ln}
    assert sorted(launches) == sorted(services), launches
    zero = {"fused_gather_mlp_score": 0, "rule_weighted_sum": 0, "segment_sum": 0}
    for name in services:
        on_device = name.startswith(("trainer", "scheduler"))
        assert launches[name] == (zero if on_device else {}), (name, launches[name])
