"""The reference's e2e loop, unchanged, against the port's cluster.

``run_local.cluster(device="cpu", manager_standby=True)`` brings up the
port's cluster with a leader + hot-standby manager pair, and the
reference's ``deploy/e2e_loop.py`` drives it: the JAX package's clients
on the port's wires, and in stage 4 the JAX ``MLEvaluator`` installs the
model the port's trainer trained.

The script runs from a copy under the test's own directory in which one
literal differs: its shard path, a fixed file under ``/tmp`` that other
runs of the same script (the reference's own cluster tests among them)
write at the same time.  Every other byte is the reference's."""

import os
import subprocess
import sys

from _torch_deploy_run import REPO

from dragonfly2_tpu_torch.deploy import run_local

SHARD_LITERAL = '"/tmp/e2e_download.dfc"'


def test_reference_e2e_against_the_ports_standby_cluster(monkeypatch, tmp_path):
    source = (REPO / "deploy" / "e2e_loop.py").read_text()
    assert source.count(SHARD_LITERAL) == 1
    script = tmp_path / "e2e_loop.py"
    script.write_text(source.replace(SHARD_LITERAL, repr(str(tmp_path / "e2e_download.dfc"))))
    # One intra-op thread a torch process, as in the other cluster files.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with run_local.cluster(device="cpu", manager_standby=True) as env:
        assert "," in env["MANAGER_URLS"]
        r = subprocess.run(
            [sys.executable, str(script)],
            capture_output=True, text=True, timeout=300,
            env={**env, "JAX_PLATFORMS": "cpu"},
        )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert "e2e: model v1 activated; ML evaluator hot-swapped" in r.stdout
    assert "e2e: ALL STAGES PASSED" in r.stdout
    assert (tmp_path / "e2e_download.dfc").stat().st_size > 0
