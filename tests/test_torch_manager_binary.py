"""Port parity: the manager binary, its searcher, dynconfig and CRUD rows,
``dragonfly2_tpu_torch`` against ``dragonfly2_tpu``.

The cases of ``tests/test_manager.py`` (``TestSearcher``,
``TestDynconfig``, ``TestCrudRest``, ``TestConfigCrud``) run on both
packages (``pkg``).  Then the two against each other:

- the same request sequence, drawn from a seeded numpy generator, to the
  JAX ``ManagerRESTServer`` and the port's: status codes and bodies are
  equal byte for byte once generated ids are replaced by their order of
  appearance;
- the port's manager binary runs as a subprocess: each config key whose
  reader is not ported, a gRPC port and ``--replicate-from`` exit 2
  naming their ROADMAP item, ``--list-models`` prints what the JAX
  binary prints on the same blob directory, and in serve mode it prints
  its URL line, answers REST and exits 0 on SIGTERM.
"""

from __future__ import annotations

import json
import os
import re
import select
import signal
import subprocess
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import dragonfly2_tpu.manager as j_manager
import dragonfly2_tpu.manager.crud as j_crud
import dragonfly2_tpu.manager.rest as j_rest
import dragonfly2_tpu.scheduler as j_scheduler
import dragonfly2_tpu_torch.manager as t_manager
import dragonfly2_tpu_torch.manager.crud as t_crud
import dragonfly2_tpu_torch.manager.rest as t_rest
import dragonfly2_tpu_torch.scheduler as t_scheduler

REPO = Path(__file__).resolve().parents[1]
SEED = 21


def _ns(manager, crud, rest, scheduler):
    return types.SimpleNamespace(
        ClusterManager=manager.ClusterManager, ClusterScopes=manager.ClusterScopes,
        Dynconfig=manager.Dynconfig, DynconfigServer=manager.DynconfigServer,
        ModelRegistry=manager.ModelRegistry, SchedulerCluster=manager.SchedulerCluster,
        Searcher=manager.Searcher, CrudStore=crud.CrudStore,
        ManagerRESTServer=rest.ManagerRESTServer, Evaluator=scheduler.Evaluator,
        Scheduling=scheduler.Scheduling, SchedulingConfig=scheduler.SchedulingConfig,
    )


PKGS = {"jax": _ns(j_manager, j_crud, j_rest, j_scheduler),
        "torch": _ns(t_manager, t_crud, t_rest, t_scheduler)}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read() or b"{}")


# -- tests/test_manager.py ----------------------------------------------------


class TestSearcher:
    def _clusters(self, pkg):
        return [
            pkg.SchedulerCluster(id="c-idc", scopes=pkg.ClusterScopes(idc="idc-a|idc-b"),
                                 scheduler_ids=["s1"]),
            pkg.SchedulerCluster(id="c-cidr", scopes=pkg.ClusterScopes(cidrs=("10.1.0.0/16",)),
                                 scheduler_ids=["s2"]),
            pkg.SchedulerCluster(id="c-default", is_default=True, scheduler_ids=["s3"]),
            pkg.SchedulerCluster(id="c-empty", scheduler_ids=[]),
        ]

    def test_cidr_wins_for_matching_ip(self, pkg):
        ranked = pkg.Searcher().find_scheduler_clusters(self._clusters(pkg), ip="10.1.2.3")
        assert ranked[0].id == "c-cidr"

    def test_idc_condition_ranks_idc_cluster(self, pkg):
        ranked = pkg.Searcher().find_scheduler_clusters(
            self._clusters(pkg), ip="192.168.0.1", conditions={"idc": "idc-b"})
        assert ranked[0].id == "c-idc"

    def test_empty_clusters_filtered_and_default_last_resort(self, pkg):
        ranked = pkg.Searcher().find_scheduler_clusters(self._clusters(pkg), ip="192.168.0.1")
        assert "c-empty" not in [c.id for c in ranked]
        assert ranked[0].id == "c-default"

    def test_no_live_clusters_raises(self, pkg):
        with pytest.raises(LookupError):
            pkg.Searcher().find_scheduler_clusters(
                [pkg.SchedulerCluster(id="x", scheduler_ids=[])])

    def test_hostname_regex(self, pkg):
        c = pkg.SchedulerCluster(id="c", scopes=pkg.ClusterScopes(hostnames=(r"^edge-\d+$",)),
                                 scheduler_ids=["s"])
        s = pkg.Searcher()
        assert s.evaluate(c, hostname="edge-42") > s.evaluate(c, hostname="core-1")


def test_searchers_score_alike():
    """Seeded clusters and joining hosts: both searchers give the same
    scores and the same ranking."""
    r = np.random.default_rng(SEED)
    specs = []
    for i in range(12):
        specs.append(dict(
            id=f"c{i}", is_default=i == 0,
            idc="|".join(f"idc-{k}" for k in r.choice(6, int(r.integers(0, 3)), replace=False)),
            location="|".join(f"l{k}" for k in r.integers(0, 3, int(r.integers(0, 4)))),
            cidrs=tuple(f"10.{k}.0.0/16" for k in r.choice(8, int(r.integers(0, 2)))),
            hostnames=(r"^edge-\d+$",) if r.random() < 0.3 else (),
            live=bool(r.random() < 0.8)))
    ranked, scores = {}, {}
    for name, pkg in PKGS.items():
        clusters = [pkg.SchedulerCluster(
            id=s["id"], is_default=s["is_default"],
            scopes=pkg.ClusterScopes(idc=s["idc"], location=s["location"], cidrs=s["cidrs"],
                                     hostnames=s["hostnames"]),
            scheduler_ids=["s"] if s["live"] else []) for s in specs]
        searcher = pkg.Searcher()
        rr = np.random.default_rng(SEED + 1)
        ranked[name], scores[name] = [], []
        for _ in range(40):
            kw = dict(ip=f"10.{int(rr.integers(0, 9))}.1.2", hostname=rr.choice(
                ["edge-7", "core-1", ""]), conditions={
                "idc": f"idc-{int(rr.integers(0, 7))}",
                "location": "|".join(f"l{k}" for k in rr.integers(0, 3, 3))})
            ranked[name].append([c.id for c in searcher.find_scheduler_clusters(
                clusters, **kw)])
            cond = kw.pop("conditions")
            scores[name].append([searcher.evaluate(c, **kw, **cond) for c in clusters])
    assert ranked["torch"] == ranked["jax"] and scores["torch"] == scores["jax"]


class TestDynconfig:
    def test_observer_notified_on_change(self, pkg, tmp_path):
        server = pkg.DynconfigServer()
        server.set("scheduler-1", {"filter_parent_limit": 15})
        seen = []
        dc = pkg.Dynconfig(lambda: server.get("scheduler-1")[0],
                           cache_path=str(tmp_path / "cache.json"))
        dc.register(seen.append)
        assert dc.refresh() is True
        server.update("scheduler-1", filter_parent_limit=30)
        assert dc.refresh() is True
        assert dc.refresh() is False  # unchanged
        assert seen[-1]["filter_parent_limit"] == 30

    def test_disk_fallback_on_manager_outage(self, pkg, tmp_path):
        cache = str(tmp_path / "cache.json")
        server = pkg.DynconfigServer()
        server.set("s", {"x": 1})
        pkg.Dynconfig(lambda: server.get("s")[0], cache_path=cache).refresh()

        def down():
            raise ConnectionError("manager unreachable")

        assert pkg.Dynconfig(down, cache_path=cache).get() == {"x": 1}

    def test_no_cache_no_manager_raises(self, pkg):
        def down():
            raise ConnectionError()

        with pytest.raises(RuntimeError):
            pkg.Dynconfig(down).get()


def test_dynconfig_cache_files_are_read_across_packages(tmp_path):
    """A cache one package wrote through a refresh serves the other's
    observers through a manager outage."""
    def down():
        raise ConnectionError("manager unreachable")

    payload = {"cluster_id": "default", "scheduler_cluster_config": {
        "candidate_parent_limit": 3, "filter_parent_limit": 11}}
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        cache = str(tmp_path / f"{writer}.json")
        PKGS[writer].Dynconfig(lambda: payload, cache_path=cache).refresh()
        seen = []
        dc = PKGS[reader].Dynconfig(down, cache_path=cache)
        dc.register(seen.append)
        assert dc.refresh() is False and seen == [payload]


class TestCrudRest:
    def _server(self, pkg, db_path=None):
        crud = pkg.CrudStore(db_path)
        server = pkg.ManagerRESTServer(pkg.ModelRegistry(), pkg.ClusterManager(), crud=crud)
        server.serve()
        return server, crud

    def test_application_crud_roundtrip(self, pkg):
        server, _ = self._server(pkg)
        try:
            app = _call(server.url, "POST", "/api/v1/applications",
                        {"name": "ml-models", "url": "https://m", "priority": 2})
            assert app["name"] == "ml-models" and app["priority"] == 2
            got = _call(server.url, "GET", "/api/v1/applications")
            assert [a["name"] for a in got] == ["ml-models"]
            upd = _call(server.url, "POST", f"/api/v1/applications/{app['id']}:update",
                        {"priority": 5})
            assert upd["priority"] == 5
            _call(server.url, "POST", f"/api/v1/applications/{app['id']}:delete", {})
            assert _call(server.url, "GET", "/api/v1/applications") == []
        finally:
            server.stop()

    def test_cluster_config_endpoint_and_persistence(self, pkg, tmp_path):
        db = str(tmp_path / "crud.db")
        server, _ = self._server(pkg, db)
        try:
            cfg = _call(server.url, "GET", "/api/v1/clusters/default:config")
            assert cfg["scheduler_cluster_config"]["candidate_parent_limit"] == 4
            _call(server.url, "POST", "/api/v1/clusters/default:update",
                  {"scheduler_cluster_config": {"candidate_parent_limit": 2,
                                                "filter_parent_limit": 9}})
            cfg = _call(server.url, "GET", "/api/v1/clusters/default:config")
            assert cfg["scheduler_cluster_config"] == {
                "candidate_parent_limit": 2, "filter_parent_limit": 9}
            with pytest.raises(urllib.error.HTTPError):
                _call(server.url, "GET", "/api/v1/clusters/ghost:config")
        finally:
            server.stop()
        server2, _ = self._server(pkg, db)
        try:
            cfg = _call(server2.url, "GET", "/api/v1/clusters/default:config")
            assert cfg["scheduler_cluster_config"]["candidate_parent_limit"] == 2
        finally:
            server2.stop()

    def test_dynconfig_applies_limits_live(self, pkg):
        server, _ = self._server(pkg)
        scheduling = pkg.Scheduling(pkg.Evaluator(), pkg.SchedulingConfig(retry_interval=0))
        try:
            def fetch():
                return _call(server.url, "GET", "/api/v1/clusters/default:config")

            def apply(data):
                scc = data.get("scheduler_cluster_config") or {}
                for key in ("candidate_parent_limit", "filter_parent_limit"):
                    if key in scc:
                        setattr(scheduling.config, key, int(scc[key]))

            dyn = pkg.Dynconfig(fetch, refresh_interval=999.0)
            dyn.register(apply)
            dyn.refresh()
            assert scheduling.config.candidate_parent_limit == 4
            _call(server.url, "POST", "/api/v1/clusters/default:update",
                  {"scheduler_cluster_config": {"candidate_parent_limit": 1,
                                                "filter_parent_limit": 3}})
            dyn.refresh()
            assert scheduling.config.candidate_parent_limit == 1
            assert scheduling.config.filter_parent_limit == 3
        finally:
            server.stop()

    def test_write_path_validation_and_default_resilience(self, pkg, tmp_path):
        server, _ = self._server(pkg)
        try:
            for path, body in (
                ("/api/v1/clusters", {"id": "x');alert(1)//", "name": "evil"}),
                ("/api/v1/clusters/default:update",
                 {"scheduler_cluster_config": {"candidate_parent_limit": "oops"}}),
                ("/api/v1/clusters/default:update", {"scheduler_cluster_config": 5}),
            ):
                with pytest.raises(urllib.error.HTTPError) as exc:
                    _call(server.url, "POST", path, body)
                assert exc.value.code == 400
        finally:
            server.stop()
        db = str(tmp_path / "crud2.db")
        store = pkg.CrudStore(db)
        store.ensure_default_cluster()
        store.update("cluster", "default", is_default=False)
        assert pkg.CrudStore(db).ensure_default_cluster().id == "default"


class TestConfigCrud:
    def test_config_rows_roundtrip(self, pkg, tmp_path):
        db = str(tmp_path / "crud.db")
        server = pkg.ManagerRESTServer(pkg.ModelRegistry(), pkg.ClusterManager(),
                                       crud=pkg.CrudStore(db))
        server.serve()
        try:
            row = _call(server.url, "POST", "/api/v1/configs",
                        {"name": "gc.interval", "value": "60", "bio": "ops"})
            assert row["name"] == "gc.interval"
            _call(server.url, "POST", f"/api/v1/configs/{row['id']}:update", {"value": "120"})
            got = _call(server.url, "GET", "/api/v1/configs")
            assert [(c["name"], c["value"]) for c in got] == [("gc.interval", "120")]
        finally:
            server.stop()
        server2 = pkg.ManagerRESTServer(pkg.ModelRegistry(), pkg.ClusterManager(),
                                        crud=pkg.CrudStore(db))
        server2.serve()
        try:
            got = _call(server2.url, "GET", "/api/v1/configs")
            assert got[0]["value"] == "120"
            _call(server2.url, "POST", f"/api/v1/configs/{got[0]['id']}:delete", {})
            assert _call(server2.url, "GET", "/api/v1/configs") == []
        finally:
            server2.stop()

    def test_config_name_unique(self, pkg):
        store = pkg.CrudStore()
        store.create("config", name="x", value="1")
        with pytest.raises(ValueError):
            store.create("config", name="x", value="2")
        with pytest.raises(ValueError):
            store.create("config", value="no-name")


# -- the two REST servers against each other ---------------------------------


def _raw(url, method, path, body=None):
    """→ (status, raw body bytes)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _wire_sequence(url):
    """A seeded request sequence over the jobs, CRUD, cluster-config and
    search routes; each request may depend on earlier answers."""
    r = np.random.default_rng(SEED)
    log = []

    def call(method, path, body=None):
        status, raw = _raw(url, method, path, body)
        log.append((method, path, status, raw))
        try:
            return json.loads(raw)
        except ValueError:
            return None

    for i in range(3):
        call("POST", "/api/v1/schedulers", {
            "id": f"sched-{i}", "cluster_id": "default" if i < 2 else "c-edge",
            "hostname": f"h{i}", "ip": f"10.0.0.{i}", "port": 8002 + i})
    call("GET", "/api/v1/clusters")
    call("GET", "/api/v1/clusters/default:config")
    call("POST", "/api/v1/clusters", {"id": "c-edge", "name": "edge",
                                      "scopes": {"idc": "idc-e", "cidrs": ["10.9.0.0/16"]},
                                      "scheduler_cluster_config": {"filter_parent_limit": 6}})
    call("POST", "/api/v1/clusters", {"id": "c-edge", "name": "dup"})
    call("POST", "/api/v1/clusters", {"id": "bad id!", "name": "x"})
    call("GET", "/api/v1/clusters/c-edge:config")
    call("POST", "/api/v1/clusters/default:update",
         {"scheduler_cluster_config": {"filter_parent_limit": int(r.integers(2, 9)),
                                       "candidate_parent_limit": 4},
          "tenant_qos": {"t-gold": {"tenant_class": "gold", "weight": 4.0}}})
    call("POST", "/api/v1/clusters/default:update", {"scheduler_cluster_config": "x"})
    call("POST", "/api/v1/clusters/ghost:update", {"name": "g"})
    call("GET", "/api/v1/clusters/default:config")
    call("GET", "/api/v1/clusters/ghost:config")
    for q in ({"ip": "10.9.1.1"}, {"idc": "idc-e"}, {"ip": "192.168.1.1", "hostname": "x"}):
        call("GET", "/api/v1/clusters:search?" + "&".join(f"{k}={v}" for k, v in q.items()))
    for i in range(3):
        call("POST", "/api/v1/applications", {"name": f"app-{i}", "url": f"https://a/{i}",
                                              "priority": int(r.integers(0, 5))})
    apps = call("GET", "/api/v1/applications")
    call("POST", f"/api/v1/applications/{apps[0]['id']}:update", {"bio": "hot"})
    call("POST", f"/api/v1/applications/{apps[1]['id']}:delete", {})
    call("POST", f"/api/v1/applications/{apps[1]['id']}:nope", {})
    call("POST", "/api/v1/applications/ghost:delete", {})
    call("POST", "/api/v1/configs", {"name": "gc.interval", "value": "60"})
    call("POST", "/api/v1/configs", {"name": "gc.interval", "value": "61"})
    call("GET", "/api/v1/configs")
    groups = []
    for g in range(3):
        queues = [f"scheduler:sched-{k}" for k in sorted(
            r.choice(3, int(r.integers(1, 3)), replace=False))]
        groups.append(call("POST", "/api/v1/jobs", {
            "type": "preheat" if g % 2 == 0 else "sync_peers",
            "args": {"urls": [f"https://o/{g}"]}, "queues": queues})["group_id"])
    call("POST", "/api/v1/jobs", {"type": "preheat"})
    for k in range(3):
        queue = f"scheduler:sched-{k}"
        while True:
            job = call("POST", "/api/v1/jobs:poll", {"queue": queue, "timeout_s": 0.01})
            if not job:
                break
            ok = bool(r.random() < 0.6)
            call("POST", f"/api/v1/jobs/{job['id']}:result",
                 {"state": "SUCCESS" if ok else "FAILURE",
                  "result": {"n": int(r.integers(0, 9))} if ok else None,
                  "error": "" if ok else "origin 503"})
    call("POST", "/api/v1/jobs:poll", {})
    call("POST", "/api/v1/jobs/ghost:result", {"state": "SUCCESS"})
    call("POST", "/api/v1/jobs/ghost:result", {"state": "RUNNING?"})
    for gid in groups:
        call("GET", f"/api/v1/jobs/{gid}")
    call("GET", "/api/v1/jobs")
    call("GET", "/api/v1/jobs/ghost")
    call("POST", "/api/v1/clusters/c-edge:delete", {})
    call("GET", "/api/v1/clusters")
    return log


def test_rest_servers_answer_byte_for_byte():
    logs = {}
    for name, pkg in PKGS.items():
        srv = pkg.ManagerRESTServer(pkg.ModelRegistry(), pkg.ClusterManager())
        srv.serve()
        try:
            logs[name] = _wire_sequence(srv.url)
        finally:
            srv.stop()

    def normalized(log):
        ids = {}

        def sub(m):
            return ids.setdefault(m.group(0), f"ID{len(ids)}").encode()

        return [(m, re.sub(r"[0-9a-f]{12}(?:[0-9a-f]{20})?",
                           lambda x: sub(x).decode(), p), s,
                 re.sub(rb"[0-9a-f]{12}(?:[0-9a-f]{20})?", sub, raw))
                for m, p, s, raw in log]

    assert len(logs["torch"]) == len(logs["jax"]) > 45
    for j, t in zip(normalized(logs["jax"]), normalized(logs["torch"])):
        assert t == j
    statuses = {s for _, _, s, _ in logs["torch"]}
    assert statuses == {200, 400, 404}


# -- the manager binary -------------------------------------------------------


def _binary(argv, env, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cli.manager", *argv],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO), **env})


@pytest.mark.parametrize("text,item", [
    ("ha: {enable: true}\n", "item 14"),
    ("token_secret: 0123456789abcdef0123\n", "item 14"),
    ("users_db: users.db\n", "item 14"),
    ("root_password: hunter2\n", "item 14"),
    ("oauth_providers: [{name: gh}]\n", "item 14"),
    ("ca_dir: ca\n", "item 14"),
    ("objectstorage: {kind: fs}\n", "item 14"),
    ("metrics: {enable: true}\n", "ported"),
    ("server: {grpc_port: 0}\n", "grpc"),
    ("--replicate-from", "item 14"),
])
def test_refused_options_exit_2_naming_their_item(tmp_path, text, item):
    env = {"DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR": str(tmp_path / "blobs"),
           "DRAGONFLY_MANAGER_SERVER_PORT": "0"}
    if text == "--replicate-from":
        argv = ["--replicate-from", "http://127.0.0.1:9"]
    else:
        (tmp_path / "m.yaml").write_text(text)
        argv = ["--config", str(tmp_path / "m.yaml")]
    if item == "ported":
        # The metrics section loads as the reference's: the manager serves
        # /metrics on its REST port (tests/test_torch_diagnostics.py).
        from dragonfly2_tpu_torch.config import ManagerConfig, load_config

        cfg = load_config(ManagerConfig, str(tmp_path / "m.yaml"), env=False)
        assert (cfg.metrics.enable, cfg.metrics.port) == (True, 8000)
        return
    if item == "grpc":
        # A gRPC port on a machine without grpc: exit 2, naming the
        # package, before anything is built.
        stub = tmp_path / "nogrpc"
        stub.mkdir()
        (stub / "grpc.py").write_text(
            "raise ModuleNotFoundError(\"No module named 'grpc'\", name='grpc')\n")
        env = {**env, "PYTHONPATH": f"{stub}{os.pathsep}{REPO}"}
        item = "'grpc' is not installed"
    out = _binary(argv, env)
    assert out.returncode == 2, out.stderr
    assert out.stderr.startswith("manager: ") and (
        f"ROADMAP queue 1 {item}" in out.stderr or item.startswith("'grpc'")
        and item in out.stderr), out.stderr
    assert not (tmp_path / "blobs").exists()


def test_list_models_prints_what_the_jax_binary_prints(tmp_path):
    from dragonfly2_tpu_torch.cli import manager as manager_cli
    from dragonfly2_tpu_torch.config import ManagerConfig

    blobs = tmp_path / "blobs"
    env = {"DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR": str(blobs), "JAX_PLATFORMS": "cpu"}
    empty = _binary(["--list-models"], env)
    assert empty.returncode == 0 and empty.stdout == "manager: registry empty\n"
    cfg = ManagerConfig()
    cfg.registry.blob_dir = str(blobs)
    parts = manager_cli.build(cfg)
    r = np.random.default_rng(SEED)
    registry = parts["registry"]
    made = [registry.create_model(
        name=name, type="mlp" if name == "mlp-ranker" else "gnn", scheduler_id=f"sched-{k}",
        artifact=r.bytes(64), evaluation={"mae": round(float(r.random()), 4)})
        for k in range(2) for name in ("mlp-ranker", "gnn-ranker")]
    registry.activate(made[0].id)
    parts["state_backend"].close()
    port = _binary(["--list-models"], env)
    ref = subprocess.run([sys.executable, "-m", "dragonfly2_tpu.cli.manager", "--list-models"],
                         capture_output=True, text=True, timeout=120, cwd=str(REPO),
                         env={**os.environ, "PYTHONPATH": str(REPO), **env})
    assert port.returncode == ref.returncode == 0, (port.stderr, ref.stderr)
    assert port.stdout == ref.stdout and len(port.stdout.splitlines()) == 4
    assert "state=active" in port.stdout


def test_serve_mode_prints_its_url_answers_and_exits_0_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cli.manager"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO),
             "DRAGONFLY_MANAGER_SERVER_HOST": "127.0.0.1",
             "DRAGONFLY_MANAGER_SERVER_PORT": "0",
             "DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR": str(tmp_path / "blobs")})
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, "the manager binary printed nothing"
        line = proc.stdout.readline()
        m = re.fullmatch(r"manager: serving REST on (http://127\.0\.0\.1:\d+) "
                         r"\(ctrl-c to stop\)\n", line)
        assert m, line
        url = m.group(1)
        assert _call(url, "GET", "/api/v1/healthy") == {"ok": True}
        cfg = _call(url, "GET", "/api/v1/clusters/default:config")
        assert cfg["scheduler_cluster_config"] == {"candidate_parent_limit": 4,
                                                   "filter_parent_limit": 15}
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0, proc.stderr.read()
    assert (tmp_path / "blobs" / "manager-state.db").exists()
