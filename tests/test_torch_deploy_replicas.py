"""The port's 2-replica topology (``run_local --device cpu --replicas``):
daemons steer tasks onto their consistent-hash owner, and a probe pushed
to replica A becomes ranking input on replica B through the manager's
topology sync."""

from _torch_deploy_run import check_passed, run_local


def test_run_local_two_scheduler_replicas():
    r = run_local("--replicas")
    check_passed(r, ["manager", "trainer", "scheduler", "scheduler-1", "seed",
                     "daemon-a", "daemon-b"])
    assert "landed on their ring owners" in r.stdout
    assert "ranks on replica B" in r.stdout
