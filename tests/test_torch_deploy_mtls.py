"""The port's cluster with auto-issued mTLS (``run_local --device cpu
--mtls``): every daemon bootstraps its identity from the manager's
cluster CA and the piece plane moves bytes over mutual TLS."""

import pytest
from _torch_deploy_run import check_passed, run_local

try:
    import cryptography  # noqa: F401

    _HAS_CRYPTO = True
except ImportError:
    _HAS_CRYPTO = False


@pytest.mark.skipif(not _HAS_CRYPTO, reason="mTLS issuance needs `cryptography`")
def test_run_local_cluster_loop_mtls():
    r = run_local("--mtls")
    check_passed(r, ["manager", "trainer", "scheduler", "seed", "daemon-a", "daemon-b"])
