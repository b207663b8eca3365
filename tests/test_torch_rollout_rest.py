"""Port parity: the rollout plane over the wire and the shadow replay log —
``dragonfly2_tpu_torch/{manager/rest,rollout/client,rollout/reporter,
rollout/shadow,rollout/evaluation,lifecycle/daemon}`` against the same
modules of ``dragonfly2_tpu``.

- Port counterparts of ``tests/test_rollout.py`` ``TestRolloutREST``,
  ``TestSubscriberRolloutIntegration`` (each subscriber case with the
  in-process client and with ``RolloutRESTClient`` over the port's
  manager) and ``test_replay_log_rows_and_ranks`` (memory and disk).
- One seeded sequence of ``begin`` / ``report`` / ``rollouts`` /
  ``rollouts:get`` / ``:candidate`` / ``:delete`` calls gets the same
  status codes and byte-equal JSON from both packages' managers with a
  ``RolloutController`` (each rollout row's ``started_at`` and
  ``updated_at``, wall-clock stamps, are set to 0 in both bodies before
  the bytes are compared), and so does ``:delete`` without a controller.
- Each package's ``RolloutRESTClient`` against each package's manager.
- The same samples through both packages' ``ShadowScorer(log_path=)``
  give byte-equal DFC1 files, before and after a resume that continues
  ``announce_seq``; ``load_replay_rows`` and ``file_replay_source`` return
  equal arrays in both packages.

Every comparison is exact.  Every server binds port 0 and is stopped in
a ``finally``; every client call has a timeout.
"""

from __future__ import annotations

import json
import re
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import dragonfly2_tpu.lifecycle as j_lifecycle
import dragonfly2_tpu.manager as j_manager
import dragonfly2_tpu.manager.rest as j_rest
import dragonfly2_tpu.records.columnar as j_columnar
import dragonfly2_tpu.rollout as j_rollout
import dragonfly2_tpu.rpc as j_rpc
import dragonfly2_tpu.scheduler as j_sched
import dragonfly2_tpu.sim.swarm as j_swarm
import dragonfly2_tpu.trainer.export as j_export
import dragonfly2_tpu_torch.lifecycle as t_lifecycle
import dragonfly2_tpu_torch.manager as t_manager
import dragonfly2_tpu_torch.manager.rest as t_rest
import dragonfly2_tpu_torch.records.columnar as t_columnar
import dragonfly2_tpu_torch.rollout as t_rollout
import dragonfly2_tpu_torch.rpc as t_rpc
import dragonfly2_tpu_torch.scheduler as t_sched
import dragonfly2_tpu_torch.sim.swarm as t_swarm
import dragonfly2_tpu_torch.trainer.export as t_export
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, DOWNLOAD_FEATURE_DIM
from dragonfly2_tpu_torch.rollout.shadow import SHADOW_COLUMNS

TIMEOUT = 10.0
MODEL_NAME = "parent-bandwidth-mlp"
_COL = {name: i for i, name in enumerate(SHADOW_COLUMNS)}


def _pkg(**mods):
    return types.SimpleNamespace(**mods)


JAX = _pkg(name="jax", lifecycle=j_lifecycle, manager=j_manager, rest=j_rest,
           columnar=j_columnar, rollout=j_rollout, rpc=j_rpc, sched=j_sched, swarm=j_swarm,
           export=j_export)
PORT = _pkg(name="port", lifecycle=t_lifecycle, manager=t_manager, rest=t_rest,
            columnar=t_columnar, rollout=t_rollout, rpc=t_rpc, sched=t_sched, swarm=t_swarm,
            export=t_export)
PKGS = {"jax": JAX, "port": PORT}


def _mk_weights(seed, invert=False):
    rng = np.random.default_rng(seed)
    dims = (DOWNLOAD_FEATURE_DIM, 16, 1)
    ws = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
           rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
          for i in range(len(dims) - 1)]
    if invert:
        ws[-1] = (-ws[-1][0], -ws[-1][1])
    return ws


def _blob(p, seed, invert=False):
    return p.export.scorer_to_bytes(p.export.MLPScorer(weights=_mk_weights(seed, invert)))


def _registry_v1_active_v2(p, sched="s1", invert_v2=True, v2_seed=2):
    reg = p.manager.ModelRegistry()
    m1 = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id=sched,
                          artifact=_blob(p, 1))
    reg.activate(m1.id)
    m2 = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id=sched,
                          artifact=_blob(p, v2_seed, invert=invert_v2))
    return reg, m1, m2


def _report(joined=500, cand_regret=0.1, active_regret=0.1, cand_inv=0.2, active_inv=0.2,
            psi=0.01):
    return {"joined_edges": joined, "announces": joined // 4,
            "regret_at_k": {"k": 4, "candidate": cand_regret, "active": active_regret},
            "inversion_rate": {"pairs": joined, "candidate": cand_inv, "active": active_inv},
            "psi_max": psi}


def _server(p, reg, ctrl):
    srv = p.rest.ManagerRESTServer(reg, p.manager.ClusterManager(), rollout=ctrl)
    srv.serve()
    return srv


def _call(base, method, path, body=None):
    """→ (status, raw body bytes)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _json(base, method, path, body=None):
    status, raw = _call(base, method, path, body)
    if status >= 400:
        raise urllib.error.HTTPError(base + path, status, raw.decode(), None, None)
    return json.loads(raw or b"{}")


# ---------------------------------------------------------------------------
# TestRolloutREST counterparts (tests/test_rollout.py:919-1009)
# ---------------------------------------------------------------------------


def _rest_server():
    reg, m1, m2 = _registry_v1_active_v2(PORT, sched="s-rest")
    ctrl = t_rollout.RolloutController(reg, guardrails=t_rollout.RolloutGuardrails(
        min_shadow_samples=1))
    return _server(PORT, reg, ctrl), reg, ctrl, m1, m2


def test_rollout_routes_roundtrip():
    server, reg, ctrl, m1, m2 = _rest_server()
    cand_path = f"/api/v1/models:candidate?scheduler_id=s-rest&name={MODEL_NAME}"
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _json(server.url, "GET", cand_path)
        assert exc.value.code == 404
        r = _json(server.url, "POST", f"/api/v1/models/{m2.id}:rollout",
                  {"canary_percent": 15})
        assert r["phase"] == "shadow" and r["canary_percent"] == 15
        cand = _json(server.url, "GET", cand_path)
        assert cand["model"]["id"] == m2.id
        assert cand["model"]["artifact_digest"]
        assert cand["phase"] == "shadow" and cand["canary_percent"] == 15
        out = _json(server.url, "POST", "/api/v1/rollouts:report",
                    {"scheduler_id": "s-rest", "name": MODEL_NAME, "report": _report(joined=5)})
        assert out["decision"] == "advance"
        listing = _json(server.url, "GET", "/api/v1/rollouts")
        assert [x["model_id"] for x in listing] == [m2.id]
        one = _json(server.url, "GET",
                    f"/api/v1/rollouts:get?scheduler_id=s-rest&name={MODEL_NAME}")
        assert one["phase"] == "canary"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _json(server.url, "POST", "/api/v1/rollouts:report",
                  {"scheduler_id": "ghost", "name": MODEL_NAME, "report": {}})
        assert exc.value.code == 404
    finally:
        server.stop()


def test_remote_registry_verifies_digest_over_the_wire():
    import dataclasses

    server, reg, ctrl, m1, m2 = _rest_server()
    try:
        remote = t_rpc.RemoteRegistry(server.url, timeout=3.0)
        model = remote.active_model("s-rest", MODEL_NAME)
        assert model.artifact_digest == m1.artifact_digest
        assert t_export.load_scorer(remote.load_artifact(model)) is not None
        tampered = dataclasses.replace(model, artifact_digest="0" * 64)
        with pytest.raises(t_manager.ArtifactDigestError):
            remote.load_artifact(tampered)
        reg.blobs.put(m1.blob_key, b"tampered")
        with pytest.raises(KeyError):
            remote.load_artifact(model)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# TestSubscriberRolloutIntegration counterparts (tests/test_rollout.py:743-808),
# each with the in-process client and with RolloutRESTClient
# ---------------------------------------------------------------------------


class _StorageStub:
    """Just enough of records.storage.Storage for RolloutReporter."""

    def __init__(self, paths):
        self._paths = list(paths)

    def download_columnar_paths(self):
        return list(self._paths)


def _clients(kind, reg, ctrl, servers):
    """(the subscriber's registry, its rollout client): in process, or
    ``RemoteRegistry`` and ``RolloutRESTClient`` over a port manager."""
    if kind == "local":
        return reg, t_rollout.LocalRolloutClient(ctrl)
    srv = _server(PORT, reg, ctrl)
    servers.append(srv)
    return (t_rpc.RemoteRegistry(srv.url, timeout=TIMEOUT),
            t_rollout.RolloutRESTClient(srv.url, timeout=TIMEOUT))


def _serving_stack(reg, client, shadow_log_path=None):
    ml = t_sched.MLEvaluator(None, feature_cache=t_sched.HostFeatureCache(max_hosts=1024),
                             batcher=t_sched.ScorerBatcher(linger_s=0.0))
    sub = t_sched.ModelSubscriber(reg, ml, scheduler_id="s1", rollout_client=client,
                                  shadow_sample_rate=1.0, shadow_log_path=shadow_log_path)
    return ml, sub


def _drive_announces(ml, task, peers, count=30, parents=8):
    for i in range(count):
        child = peers[i % len(peers)]
        cands = [peers[(i + j + 1) % len(peers)] for j in range(parents)]
        ml.evaluate_parents(cands, child, task.total_piece_count)


def _write_download_rows(path, src, dst, target_log_bw):
    rows = np.zeros((len(src), len(DOWNLOAD_COLUMNS)), np.float32)
    rows[:, 0], rows[:, 1], rows[:, -1] = src, dst, target_log_bw
    with t_columnar.ColumnarWriter(path, DOWNLOAD_COLUMNS) as w:
        w.append(rows)


@pytest.mark.parametrize("kind", ["local", "rest"])
def test_candidate_installs_shadow_then_canary_then_promotes(kind):
    reg, m1, m2 = _registry_v1_active_v2(PORT, invert_v2=False)
    ctrl = t_rollout.RolloutController(reg, guardrails=t_rollout.RolloutGuardrails(
        min_shadow_samples=1, min_canary_samples=1, canary_percent=30))
    servers = []
    try:
        ml, sub = _serving_stack(*_clients(kind, reg, ctrl, servers))
        sub.refresh()
        assert ml.shadow is None
        ctrl.begin(m2.id)
        sub.refresh()
        assert ml.shadow is not None and ml.canary is None
        ctrl.report("s1", MODEL_NAME, _report(joined=5))
        sub.refresh()
        assert ml.canary is not None and ml.canary.percent == 30
        ctrl.report("s1", MODEL_NAME, _report(joined=10))
        sub.refresh()
        assert ml.canary is None and ml.shadow is None
        assert sub._loaded_version == m2.version
        sub.stop()
    finally:
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("kind", ["local", "rest"])
def test_reporter_cycle_reports_and_applies(tmp_path, kind):
    # v2 = a clean retrain of v1 (same weights): outcome-joined quality
    # cannot show a regression.  The shadow log is on disk.
    reg, m1, m2 = _registry_v1_active_v2(PORT, invert_v2=False, v2_seed=1)
    ctrl = t_rollout.RolloutController(reg, guardrails=t_rollout.RolloutGuardrails(
        min_shadow_samples=1, min_canary_samples=10**9))
    ctrl.begin(m2.id)
    servers = []
    try:
        sub_registry, client = _clients(kind, reg, ctrl, servers)
        log_path = str(tmp_path / "shadow_replay.dfc")
        ml, sub = _serving_stack(sub_registry, client, shadow_log_path=log_path)
        sub.refresh()
        task, peers = t_swarm.build_announce_swarm(40, seed=7)
        _drive_announces(ml, task, peers, count=25, parents=6)
        ml.shadow.drain()
        rows = ml.shadow.replay_rows()
        assert rows.shape[0] == len(t_columnar.ColumnarReader(log_path)) > 0
        dl_path = str(tmp_path / "download.dfc")
        _write_download_rows(dl_path, rows[:, _COL["src_bucket"]], rows[:, _COL["dst_bucket"]],
                             np.log1p(1000.0 - rows[:, _COL["active_rank"]] * 10.0))
        reporter = t_rollout.RolloutReporter(sub, _StorageStub([dl_path]), client)
        out = reporter.run_once()
        assert out is not None
        assert out["decision"]["decision"] == "advance"
        assert out["report"]["joined_edges"] > 0
        assert out["report"]["shadow_rows"] == rows.shape[0]
        assert ml.canary is not None
        sub.stop()
    finally:
        for srv in servers:
            srv.stop()


def test_reporter_none_without_shadow():
    reg, m1, m2 = _registry_v1_active_v2(PORT)
    ctrl = t_rollout.RolloutController(reg)
    ml, sub = _serving_stack(reg, t_rollout.LocalRolloutClient(ctrl))
    sub.refresh()
    reporter = t_rollout.RolloutReporter(sub, _StorageStub([]), t_rollout.LocalRolloutClient(ctrl))
    assert reporter.run_once() is None
    sub.stop()


# ---------------------------------------------------------------------------
# The manager's rollout routes: one seeded call sequence, both packages
# ---------------------------------------------------------------------------

_STAMPS = re.compile(rb'"(started_at|updated_at)": [0-9.eE+-]+')


def _unstamped(raw: bytes) -> bytes:
    return _STAMPS.sub(rb'"\1": 0', raw)


def _sequence(p, seed):
    """A seeded call sequence → [(status, body bytes)]."""
    reg, m1, m2 = _registry_v1_active_v2(p, sched="s-seq", invert_v2=False)
    ctrl = p.rollout.RolloutController(reg, guardrails=p.rollout.RolloutGuardrails(
        min_shadow_samples=50, min_canary_samples=50, canary_percent=25))
    rng = np.random.default_rng(seed)
    q = f"scheduler_id=s-seq&name={MODEL_NAME}"
    srv = _server(p, reg, ctrl)
    out = []
    try:
        def call(method, path, body=None):
            out.append((method, path, *_call(srv.url, method, path, body)))

        call("GET", f"/api/v1/models:candidate?{q}")
        call("GET", "/api/v1/rollouts")
        call("GET", f"/api/v1/rollouts:get?{q}")
        call("POST", "/api/v1/rollouts:report",
             {"scheduler_id": "s-seq", "name": MODEL_NAME, "report": _report(joined=10)})
        call("POST", f"/api/v1/models/{m2.id}:rollout", {"canary_percent": 15})
        call("POST", f"/api/v1/models/{m1.id}:rollout", {})
        call("POST", "/api/v1/models/no-such-model:rollout", {})
        call("GET", f"/api/v1/models:candidate?{q}")
        joined = 0
        for _ in range(8):
            joined += int(rng.integers(5, 40))
            cand = float(rng.uniform(0.05, 0.12))
            call("POST", "/api/v1/rollouts:report", {
                "scheduler_id": "s-seq", "name": MODEL_NAME,
                "report": _report(joined=joined, cand_regret=cand, active_regret=0.1,
                                  cand_inv=float(rng.uniform(0.15, 0.22)), active_inv=0.2,
                                  psi=float(rng.uniform(0.0, 0.2)))})
            call("GET", f"/api/v1/rollouts:get?{q}")
            call("GET", f"/api/v1/models:candidate?{q}")
        call("POST", "/api/v1/rollouts:report",
             {"scheduler_id": "ghost", "name": MODEL_NAME, "report": {}})
        call("POST", "/api/v1/rollouts:report", {"scheduler_id": "s-seq"})
        call("GET", "/api/v1/rollouts")
        call("GET", f"/api/v1/models:active?{q}")
        call("POST", f"/api/v1/models/{m1.id}:delete")
        call("POST", "/api/v1/models/no-such-model:delete")
        call("GET", "/api/v1/rollouts")
        call("POST", f"/api/v1/models/{m2.id}:delete")
        call("GET", "/api/v1/rollouts")
        call("GET", f"/api/v1/models?scheduler_id=s-seq")
    finally:
        srv.stop()
    return [(m, path, status, _unstamped(raw)) for m, path, status, raw in out]


@pytest.mark.parametrize("seed", [0, 1])
def test_rollout_call_sequence_equals_the_jax_manager(seed):
    got, want = _sequence(PORT, seed), _sequence(JAX, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    decisions = [json.loads(raw)["decision"] for m, path, status, raw in got
                 if path == "/api/v1/rollouts:report" and status == 200]
    assert "advance" in decisions and "promote" in decisions, decisions


def test_delete_without_a_controller_equals_the_jax_manager():
    def seq(p):
        reg, m1, m2 = _registry_v1_active_v2(p, sched="s-del")
        srv = _server(p, reg, None)
        try:
            return m2.id, [_call(srv.url, "POST", f"/api/v1/models/{m2.id}:delete"),
                    _call(srv.url, "POST", f"/api/v1/models/{m2.id}:delete"),
                    _call(srv.url, "POST", f"/api/v1/models/{m1.id}:rollout", {}),
                    _call(srv.url, "GET", "/api/v1/rollouts"),
                    _call(srv.url, "GET", "/api/v1/models?scheduler_id=s-del")]
        finally:
            srv.stop()

    model_id, got = seq(PORT)
    assert (model_id, got) == seq(JAX)
    assert got[0][0] == 200 and json.loads(got[0][1]) == {"deleted": model_id}
    assert [s for s, _ in got[1:4]] == [404, 404, 404]


@pytest.mark.parametrize("client,server", [("port", "port"), ("port", "jax"),
                                           ("jax", "port"), ("jax", "jax")])
def test_rollout_clients_across_packages(client, server):
    sp, cp = PKGS[server], PKGS[client]
    reg, m1, m2 = _registry_v1_active_v2(sp, sched="s-x")
    ctrl = sp.rollout.RolloutController(reg, guardrails=sp.rollout.RolloutGuardrails(
        min_shadow_samples=50))
    srv = _server(sp, reg, ctrl)
    try:
        rc = cp.rollout.RolloutRESTClient(srv.url, timeout=TIMEOUT)
        assert rc.candidate("s-x", MODEL_NAME) is None
        begun = rc.begin(m2.id, canary_percent=20)
        assert (begun["model_id"], begun["phase"], begun["canary_percent"]) == (
            m2.id, "shadow", 20)
        info = rc.candidate("s-x", MODEL_NAME)
        assert (info.model.id, info.phase, info.canary_percent) == (m2.id, "shadow", 20)
        assert info.model.artifact_digest == m2.artifact_digest
        assert rc.report("s-x", MODEL_NAME, _report(joined=10))["decision"] == "hold"
        assert rc.report("s-x", MODEL_NAME, _report(joined=60))["decision"] == "advance"
        info = rc.candidate("s-x", MODEL_NAME)
        assert (info.phase, info.canary_percent) == ("canary", 20)
        with pytest.raises(KeyError):
            rc.report("ghost", MODEL_NAME, _report())
        with pytest.raises(KeyError):
            rc.begin("no-such-model")
        with pytest.raises(ValueError):
            rc.begin(m1.id)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# The shadow replay log on disk
# ---------------------------------------------------------------------------


class _ConstScorer:
    """Scores row i as base + step*i — rankings are predictable."""

    def __init__(self, base=0.0, step=1.0):
        self.base, self.step = base, step

    def score(self, features, **_buckets):
        return self.base + self.step * np.arange(features.shape[0], dtype=np.float64)


@pytest.mark.parametrize("on_disk", [False, True])
def test_replay_log_rows_and_ranks(tmp_path, on_disk):
    def rows(p):
        sh = p.rollout.ShadowScorer(
            _ConstScorer(step=1.0), candidate_version=3, active_version=1, sample_rate=1.0,
            log_path=str(tmp_path / f"{p.name}.dfc") if on_disk else None)
        sh.offer("c", np.zeros((3, 2), np.float32), np.array([11, 12, 13]),
                 np.array([7, 7, 7]), np.array([5.0, 1.0, 3.0]))
        sh.drain()
        sh.close()
        return sh.replay_rows()

    got = rows(PORT)
    np.testing.assert_array_equal(got, rows(JAX))
    assert got.shape == (3, len(SHADOW_COLUMNS))
    assert got[0, _COL["candidate_version"]] == 3.0
    assert got[0, _COL["active_version"]] == 1.0
    assert list(got[:, _COL["src_bucket"]]) == [11.0, 12.0, 13.0]
    assert list(got[:, _COL["active_rank"]]) == [0.0, 2.0, 1.0]
    assert list(got[:, _COL["candidate_rank"]]) == [2.0, 1.0, 0.0]
    if on_disk:
        assert (tmp_path / "port.dfc").read_bytes() == (tmp_path / "jax.dfc").read_bytes()


def _offer_all(sh, rng, announces, start=0):
    """Seeded announces, each drained before the next (one announce per
    drain: the worker's candidate scores are then bit-stable)."""
    for a in range(start, start + announces):
        n = int(rng.integers(2, 9))
        feats = rng.standard_normal((n, DOWNLOAD_FEATURE_DIM)).astype(np.float32)
        sh.offer(f"child-{a % 5}", feats, rng.integers(0, 1 << 20, n),
                 np.full(n, int(rng.integers(0, 1 << 20))), rng.standard_normal(n))
        assert sh.drain(timeout=10.0)


def _shadow_log(p, path, seed=3):
    rng = np.random.default_rng(seed)
    scorer = p.export.MLPScorer(weights=_mk_weights(4))
    sh = p.rollout.ShadowScorer(scorer, candidate_version=2, active_version=1,
                                sample_rate=0.6, log_path=path)
    _offer_all(sh, rng, 12)
    sh.close()
    first = (sh.offered, open(path, "rb").read())
    # A scheduler restart onto the same log: the offer counter resumes
    # past every logged announce_seq.
    sh2 = p.rollout.ShadowScorer(scorer, candidate_version=3, active_version=2,
                                 sample_rate=0.6, log_path=path)
    resumed = sh2.offered
    _offer_all(sh2, rng, 10)
    sh2.close()
    return first, resumed, sh2.replay_rows(), open(path, "rb").read()


def test_shadow_log_files_equal_across_packages_and_resume(tmp_path):
    (p_first, p_resumed, p_rows, p_bytes) = _shadow_log(PORT, str(tmp_path / "port.dfc"))
    (j_first, j_resumed, j_rows, j_bytes) = _shadow_log(JAX, str(tmp_path / "jax.dfc"))
    assert p_first == j_first and p_bytes == j_bytes
    assert p_resumed == j_resumed
    np.testing.assert_array_equal(p_rows, j_rows)
    seqs = p_rows[:, _COL["announce_seq"]]
    first_rows = len(t_columnar.ColumnarReader(str(tmp_path / "port.dfc")))
    assert first_rows == p_rows.shape[0]
    # Resumed seqs start past the first shadow's logged ones.
    versions = p_rows[:, _COL["candidate_version"]]
    assert seqs[versions == 3].min() >= p_resumed > seqs[versions == 2].max()
    assert set(versions) == {2.0, 3.0}


def test_load_replay_rows_and_file_replay_source_equal(tmp_path):
    rng = np.random.default_rng(5)
    shadow = rng.standard_normal((40, len(SHADOW_COLUMNS))).astype(np.float32)
    dl = rng.standard_normal((30, len(DOWNLOAD_COLUMNS))).astype(np.float32)
    paths = {}
    for name, rows, cols in (("a", shadow[:25], SHADOW_COLUMNS),
                             ("b", shadow[25:], SHADOW_COLUMNS),
                             ("dl", dl, DOWNLOAD_COLUMNS)):
        paths[name] = str(tmp_path / f"{name}.dfc")
        with t_columnar.ColumnarWriter(paths[name], cols) as w:
            w.append(rows)
    (tmp_path / "empty.dfc").write_bytes(b"")
    shards = [paths["a"], str(tmp_path / "missing.dfc"), str(tmp_path / "empty.dfc"),
              paths["b"]]
    for p in (PORT, JAX):
        np.testing.assert_array_equal(p.rollout.load_replay_rows(shards), shadow)
        empty = p.rollout.load_replay_rows([str(tmp_path / "missing.dfc")])
        assert empty.shape == (0, len(SHADOW_COLUMNS)) and empty.dtype == np.float32
        source = p.lifecycle.file_replay_source({"global": shards, "cn": []}, [paths["dl"]])
        got_shadow, got_dl = source("global")
        np.testing.assert_array_equal(got_shadow, shadow)
        np.testing.assert_array_equal(got_dl, dl)
        assert source("cn") is None and source("eu") is None
