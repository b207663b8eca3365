"""The secured cluster at a small size on the CPU
(``dragonfly2_tpu_torch/bench/secure_cluster.py``, the smoke's phase 27):
the manager as the cluster CA with users and personal access tokens, a
scheduler and four daemons that request their identities at boot,
announce over mutual TLS on the scheduler's gRPC port and move pieces
over mutual TLS, image pulls through the daemons' SNI proxies, and a
relayed host.  Every one of its checks holds, and the chain check it
relies on refuses an identity from another CA.
"""

from __future__ import annotations

import os

import pytest

pytest.importorskip("cryptography", reason="the secured cluster needs the gated CA surface")


def test_secure_cluster_small(tmp_path):
    from dragonfly2_tpu_torch.bench import secure_cluster

    summary = secure_cluster.run(secure_cluster.parse_args([
        "--daemons", "4", "--file-mib", "8", "--layers-mib", "0.25,1", "--seed", "3",
        "--out", str(tmp_path), "--device", "cpu"]), log=lambda line: None)
    assert summary["checks"] and all(summary["checks"].values()), summary
    assert summary["identities"] == 5 and summary["threads_left"] == []
    assert summary["grpc"] == {"no_client_cert": "UNAVAILABLE", "client_cert": "OK"}
    assert summary["scorer_calls"] >= 1 and summary["tls_handshakes"] > 0
    assert summary["engine"]["native_fetch_pieces"] == 0
    assert not os.path.exists(tmp_path / "secure_cluster")


def test_chain_check_refuses_another_cas_identity():
    from dragonfly2_tpu_torch.bench.secure_cluster import _chains_to
    from dragonfly2_tpu_torch.security import CertificateAuthority, PeerIdentity

    ca, other = CertificateAuthority(), CertificateAuthority()
    mine = PeerIdentity.issue(ca, common_name="d")
    assert _chains_to(mine, ca.cert_pem)
    assert not _chains_to(mine, other.cert_pem)
    forged = PeerIdentity(key_pem=mine.key_pem,
                          cert_pem=PeerIdentity.issue(other, common_name="d").cert_pem,
                          ca_pem=ca.cert_pem)
    assert not _chains_to(forged, ca.cert_pem)
