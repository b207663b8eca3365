"""The port's one-command cluster on the CPU (``run_local --device cpu``):
manager, trainer, scheduler, a seed daemon and two daemons as real
processes on real wires, and the port's e2e loop passing end to end
(the reference's ``tests/test_deploy.py::TestClusterE2E``)."""

from _torch_deploy_run import check_passed, run_local


def test_run_local_cluster_loop():
    r = run_local()
    check_passed(r, ["manager", "trainer", "scheduler", "seed", "daemon-a", "daemon-b"])
    stages = {ln.rsplit("[stage ", 1)[1].split(":")[0] for ln in r.stdout.splitlines()
              if ln.startswith("e2e: ")}
    assert stages == {"1", "2", "3", "4", "5"}, stages
