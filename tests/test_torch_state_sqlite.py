"""Port parity: the manager's SQLite state backend,
``dragonfly2_tpu_torch/manager/{state,registry}.py`` against
``dragonfly2_tpu/manager/{state,registry}.py``.

- One SQLite file written by either package reads back in the other:
  raw rows in several namespaces, and a ``ModelRegistry``'s models with
  their states after an activation and their blobs (``KVBlobStore``).
- ``migrate_legacy_sqlite`` imports the same rows from the same legacy
  files in both packages, and is a no-op the second time.
- The port's ``ModelRegistry(db_path=)`` survives a restart, and the
  reference's registry reads its file alike.
- The ``state.{put,get,delete,load_all}.<namespace>`` seams fire at the
  same sites, as many times, for the same sequence of calls; a ``drop``
  at ``state.put.models`` commits nothing in either package.
"""

from __future__ import annotations

import base64
import json
import sqlite3

import numpy as np
import pytest

import dragonfly2_tpu.manager.registry as jreg
import dragonfly2_tpu.manager.state as jstate
import dragonfly2_tpu.utils.faultinject as jfi
import dragonfly2_tpu_torch.manager.registry as treg
import dragonfly2_tpu_torch.manager.state as tstate
import dragonfly2_tpu_torch.utils.faultinject as tfi

PKGS = {"jax": (jstate, jreg, jfi), "torch": (tstate, treg, tfi)}


@pytest.fixture(autouse=True)
def _no_injector():
    saved = (jfi.active(), tfi.active())
    yield
    for mod, injector in zip((jfi, tfi), saved):
        if injector is None:
            mod.uninstall()
        else:
            mod.install(injector)


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    return {
        ns: {f"k{i:03d}": {"i": i, "v": float(rng.standard_normal()), "tag": ns,
                           "nested": {"xs": [int(x) for x in rng.integers(0, 9, 3)]}}
             for i in range(int(rng.integers(3, 12)))}
        for ns in ("crud", "jobs", "rollouts")
    }


def _fill_registry(reg_mod, backend):
    reg = reg_mod.ModelRegistry(reg_mod.KVBlobStore(backend), backend=backend)
    ids = []
    for i, (name, typ) in enumerate([("mlp-a", "mlp"), ("mlp-a", "mlp"), ("gnn-b", "gnn")]):
        m = reg.create_model(name=name, type=typ, scheduler_id="sched-1",
                             artifact=bytes([i]) * 64, evaluation={"mae": 0.1 * (i + 1)})
        ids.append(m.id)
    reg.activate(ids[1])
    return reg, ids


def _models(reg):
    return sorted(
        (m.id, m.name, m.type, m.version, m.scheduler_id, m.state.value,
         json.dumps(m.evaluation, sort_keys=True), m.blob_key)
        for m in reg.list()
    )


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_each_package_reads_the_others_db(tmp_path, writer, reader):
    path = str(tmp_path / "manager.db")
    w_state, w_reg, _ = PKGS[writer]
    backend = w_state.SQLiteBackend(path)
    rows = _rows()
    for ns, docs in rows.items():
        backend.table(ns).put_many(docs)
    backend.table("jobs").delete("k000")
    written, ids = _fill_registry(w_reg, backend)
    want = _models(written)
    backend.close()

    r_state, r_reg, _ = PKGS[reader]
    back = r_state.SQLiteBackend(path)
    try:
        rows["jobs"].pop("k000")
        for ns, docs in rows.items():
            assert back.table(ns).load_all() == docs
        assert back.table("crud").load_range("k005") == {
            k: v for k, v in rows["crud"].items() if k > "k005"}
        assert set(back.namespaces()) >= set(rows) | {"models"}
        reg = r_reg.ModelRegistry(r_reg.KVBlobStore(back), backend=back)
        assert _models(reg) == want
        assert reg.active_model("sched-1", "mlp-a").id == ids[1]
        assert reg.load_artifact(reg.get(ids[2])) == bytes([2]) * 64
    finally:
        back.close()


def _legacy_files(tmp_path):
    models = str(tmp_path / "models.db")
    conn = sqlite3.connect(models)
    conn.execute("CREATE TABLE models (id, name, type, version, scheduler_id, state, "
                 "evaluation, blob_key, created_at, updated_at)")
    conn.executemany("INSERT INTO models VALUES (?,?,?,?,?,?,?,?,?,?)", [
        (f"m{i}", "mlp", "mlp", i + 1, "s1", "inactive", json.dumps({"mae": i / 10}),
         f"blob{i}", 100.0 + i, 200.0 + i) for i in range(4)])
    conn.commit()
    conn.close()
    crud = str(tmp_path / "crud.db")
    conn = sqlite3.connect(crud)
    conn.execute("CREATE TABLE crud_rows (kind, id, value)")
    conn.executemany("INSERT INTO crud_rows VALUES (?,?,?)", [
        ("cluster", f"c{i}", json.dumps({"name": f"c{i}", "n": i})) for i in range(3)])
    conn.commit()
    conn.close()
    users = str(tmp_path / "users.db")
    conn = sqlite3.connect(users)
    conn.execute("CREATE TABLE users (id, name, email, role, state, password_hash, salt, "
                 "created_at)")
    conn.execute("CREATE TABLE pats (id, user_id, name, role, token_hash, expires_at, "
                 "revoked, created_at)")
    conn.execute("INSERT INTO users VALUES (?,?,?,?,?,?,?,?)",
                 ("u1", "ann", "a@x", 2, "enable", b"\x01\x02", b"\x03", 5.0))
    conn.execute("INSERT INTO pats VALUES (?,?,?,?,?,?,?,?)",
                 ("p1", "u1", "ci", 1, "hash", 99.0, 0, 6.0))
    conn.commit()
    conn.close()
    return {"models_db": models, "crud_db": crud, "users_db": users}


def test_migrate_legacy_sqlite_agrees(tmp_path):
    files = _legacy_files(tmp_path)
    got = {}
    for name, (state, _reg, _fi) in PKGS.items():
        backend = state.SQLiteBackend(str(tmp_path / f"{name}.db"))
        counts = state.migrate_legacy_sqlite(backend, **files)
        again = state.migrate_legacy_sqlite(backend, **files)
        tables = {ns: backend.table(ns).load_all() for ns in backend.namespaces()}
        backend.close()
        got[name] = (counts, again, tables)
    assert got["torch"] == got["jax"]
    counts, again, tables = got["torch"]
    assert counts == {"models": 4, "crud": 3, "users": 1, "pats": 1} and again == {}
    assert tables["users"]["u1"]["password_hash"] == base64.b64encode(b"\x01\x02").decode()


def test_make_state_backend_dispatches_alike(tmp_path):
    for spec in (None, "", "mem://"):
        assert isinstance(tstate.make_state_backend(spec), tstate.MemoryBackend)
    backend = tstate.make_state_backend(str(tmp_path / "sub" / "m.db"))
    assert isinstance(backend, tstate.SQLiteBackend)
    backend.close()
    backend.close()  # idempotent


def test_registry_db_path_survives_a_restart(tmp_path):
    path = str(tmp_path / "registry.db")
    reg = treg.ModelRegistry(db_path=path)
    a = reg.create_model(name="mlp", type="mlp", scheduler_id="s", artifact=b"a",
                         evaluation={"mae": 0.5})
    b = reg.create_model(name="mlp", type="mlp", scheduler_id="s", artifact=b"b",
                         evaluation={"mae": 0.4})
    reg.activate(b.id)
    reg.deactivate(b.id)
    reg.activate(a.id)
    before = _models(reg)
    restarted = treg.ModelRegistry(db_path=path)
    assert _models(restarted) == before
    assert restarted.active_model("s", "mlp").id == a.id
    c = restarted.create_model(name="mlp", type="mlp", scheduler_id="s", artifact=b"c",
                               evaluation={})
    assert c.version == 3
    # The reference's registry reads the same file the same way.
    assert _models(jreg.ModelRegistry(db_path=path)) == _models(restarted)


def _seam_run(name, backend):
    """One sequence of state calls under a counting injector; → the
    per-site call counts and what the sequence returned."""
    state, reg_mod, fi = PKGS[name]
    injector = fi.FaultInjector([])
    fi.install(injector)
    try:
        t = backend.table("jobs")
        t.put("a", {"x": 1})
        t.put_many({"b": {"x": 2}, "c": {"x": 3}})
        got = [t.get("a"), t.get("missing"), t.load_all()]
        t.delete("a")
        got.append(t.load_range("a"))
        t.delete_range("c")
        got.append(t.load_all())
        backend.put_namespaces({"crud": {"k": {"v": 1}}, "users": {"u": {"v": 2}}})
        reg_mod.ModelRegistry(backend=backend).create_model(
            name="n", type="mlp", scheduler_id="s", artifact=b"z", evaluation={})
    finally:
        fi.uninstall()
    counts = {site: n for site, n in injector._counts.items() if site.startswith("state.")}
    return counts, got


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_state_seams_fire_at_the_same_sites(tmp_path, kind):
    runs = {}
    for name, (state, _reg, _fi) in PKGS.items():
        backend = (state.MemoryBackend() if kind == "memory"
                   else state.SQLiteBackend(str(tmp_path / f"{name}.db")))
        runs[name] = _seam_run(name, backend)
        backend.close() if kind == "sqlite" else None
    assert runs["torch"] == runs["jax"]
    counts = runs["torch"][0]
    assert {"state.put.jobs", "state.get.jobs", "state.delete.jobs", "state.load_all.jobs",
            "state.put.crud", "state.put.users", "state.put.models",
            "state.load_all.models"} <= set(counts)


def test_a_dropped_put_commits_nothing(tmp_path):
    for name, (state, reg_mod, fi) in PKGS.items():
        backend = state.SQLiteBackend(str(tmp_path / f"{name}.db"))
        reg = reg_mod.ModelRegistry(backend=backend)
        fi.install(fi.FaultInjector([fi.FaultSpec(site="state.put.models", kind="drop",
                                                  at=(0,))]))
        try:
            with pytest.raises(ConnectionError):
                reg.create_model(name="n", type="mlp", scheduler_id="s", artifact=b"z",
                                 evaluation={})
        finally:
            fi.uninstall()
        assert backend.table("models").load_all() == {}
        backend.close()
