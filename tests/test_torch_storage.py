"""Port parity: record storage, ``dragonfly2_tpu_torch/records/storage.py``
against ``dragonfly2_tpu/records/storage.py``.

The same records (made once by the port's ``SyntheticCluster`` and carried
to the JAX schema through ``to_dict`` / ``from_dict``) go through both
packages' ``Storage``.  Each package reads the other's files: JSONL
records equal, DFC1 rows equal.  The JSONL files are equal byte for byte;
so are the DFC1 files wherever the JAX side writes through its Python
``ColumnarWriter`` (it prefers its native writer when that builds, which
writes the same rows under a header whose keys are in another order).
The port writes through its native writer at its defaults, whose shards
equal its Python writer's byte for byte
(``tests/test_torch_native_engine.py``).  Topology rows carry a freshness column computed
against the wall clock at flush time: it is held within 1e-3, every other
column exactly.  Rotation by size, backups, the path lists, ``clear`` and
the counts behave alike.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from dragonfly2_tpu.records import columnar as jcol
from dragonfly2_tpu.records import schema as jschema
from dragonfly2_tpu.records import storage as jstorage
from dragonfly2_tpu_torch.records import columnar as tcol
from dragonfly2_tpu_torch.records import schema
from dragonfly2_tpu_torch.records import storage as tstorage
from dragonfly2_tpu_torch.records.features import TOPO_COLUMNS
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster

FRESHNESS = TOPO_COLUMNS.index("freshness")
FRESHNESS_TOL = 1e-3


def _records(n_dl=30, n_topo=10, seed=2):
    cluster = SyntheticCluster(num_hosts=40, seed=seed)
    downloads = cluster.generate_downloads(n_dl)
    topo = cluster.generate_topology_records(n_topo)
    as_jax = [jschema.from_dict(jschema.Download, schema.to_dict(r)) for r in downloads]
    as_jax_topo = [jschema.from_dict(jschema.NetworkTopologyRecord, schema.to_dict(r))
                   for r in topo]
    return (downloads, topo), (as_jax, as_jax_topo)


def _write(store, downloads, topo):
    for r in downloads:
        store.create_download(r)
    for r in topo:
        store.create_network_topology(r)
    store.flush()


def _rows_equal(a: np.ndarray, b: np.ndarray, topo: bool) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype
    if topo:
        keep = [i for i in range(a.shape[1]) if i != FRESHNESS]
        assert np.array_equal(a[:, keep], b[:, keep])
        assert np.abs(a[:, FRESHNESS] - b[:, FRESHNESS]).max() <= FRESHNESS_TOL
    else:
        assert np.array_equal(a, b)


@pytest.mark.parametrize("python_writer", [False, True], ids=["jax_default", "jax_python"])
def test_each_package_reads_the_others_files(tmp_path, monkeypatch, python_writer):
    if python_writer:
        monkeypatch.setattr(jstorage, "_make_columnar_writer", jcol.ColumnarWriter)
    (dl, topo), (jdl, jtopo) = _records()
    port = tstorage.Storage(str(tmp_path / "port"), buffer_size=8)
    ref = jstorage.Storage(str(tmp_path / "jax"), buffer_size=8)
    _write(port, dl, topo)
    _write(ref, jdl, jtopo)
    assert port.download_count == ref.download_count == len(dl)
    assert port.network_topology_count == ref.network_topology_count == len(topo)

    # Records: the JAX reader on the port's files and the port's on JAX's.
    want = [schema.to_dict(r) for r in dl]
    assert [jschema.to_dict(r) for r in jstorage.Storage(port.directory).list_download()] == want
    assert [schema.to_dict(r) for r in tstorage.Storage(ref.directory).list_download()] == want
    want_t = [schema.to_dict(r) for r in topo]
    assert [jschema.to_dict(r) for r in
            jstorage.Storage(port.directory).list_network_topology()] == want_t
    assert [schema.to_dict(r) for r in
            tstorage.Storage(ref.directory).list_network_topology()] == want_t

    # JSONL bytes and DFC1 rows (bytes too, when JAX wrote through Python).
    for tp, jp in zip(port.download_raw_paths() + port.network_topology_raw_paths(),
                      ref.download_raw_paths() + ref.network_topology_raw_paths()):
        assert open(tp, "rb").read() == open(jp, "rb").read()
    for topo_file, tpaths, jpaths in (
            (False, port.download_columnar_paths(), ref.download_columnar_paths()),
            (True, port.network_topology_columnar_paths(),
             ref.network_topology_columnar_paths())):
        assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
        for tp, jp in zip(tpaths, jpaths):
            _rows_equal(jcol.ColumnarReader(tp).to_array(), tcol.ColumnarReader(jp).to_array(),
                        topo_file)
            _rows_equal(tcol.ColumnarReader(tp).to_array(), jcol.ColumnarReader(jp).to_array(),
                        topo_file)
            if python_writer and not topo_file:
                assert open(tp, "rb").read() == open(jp, "rb").read()


def test_rotation_backups_paths_clear_and_counts_alike(tmp_path):
    (dl, topo), (jdl, jtopo) = _records(n_dl=50, n_topo=20)
    kw = dict(buffer_size=3, max_size=6_000, max_backups=3)
    port = tstorage.Storage(str(tmp_path / "port"), **kw)
    ref = jstorage.Storage(str(tmp_path / "jax"), **kw)
    for i in range(0, len(dl), 5):
        _write(port, dl[i:i + 5], topo[i // 3: i // 3 + 2])
        _write(ref, jdl[i:i + 5], jtopo[i // 3: i // 3 + 2])
        assert sorted(os.listdir(port.directory)) == sorted(os.listdir(ref.directory))
    names = sorted(os.listdir(port.directory))
    assert "download.3.jsonl" in names and "download.4.jsonl" not in names   # capped
    rel = lambda paths: [os.path.relpath(p, os.path.dirname(p)) for p in paths]  # noqa: E731
    for method in ("download_columnar_paths", "network_topology_columnar_paths",
                   "download_raw_paths", "network_topology_raw_paths"):
        assert rel(getattr(port, method)()) == rel(getattr(ref, method)()), method
    # Newest first: the active file (when the last flush did not rotate
    # it away), then .1, .2, .3.
    assert rel(port.download_raw_paths())[-3:] == [
        "download.1.jsonl", "download.2.jsonl", "download.3.jsonl"]
    got = [schema.to_dict(r) for r in port.list_download()]
    assert got == [jschema.to_dict(r) for r in ref.list_download()]
    assert len(got) < len(dl)                          # the oldest backups were dropped
    assert port.download_count == ref.download_count == len(dl)
    assert port.network_topology_count == ref.network_topology_count
    port.clear()
    ref.clear()
    assert os.listdir(port.directory) == os.listdir(ref.directory) == []
    assert port.list_download() == [] and port.download_columnar_paths() == []
    assert port.download_count == len(dl)              # the count is of records created


def test_no_directory_until_the_first_flush(tmp_path):
    where = tmp_path / "later" / "records"
    store = tstorage.Storage(str(where), buffer_size=5)
    (dl, _), _ = _records(n_dl=4, n_topo=0)
    for r in dl:
        store.create_download(r)
    assert not where.exists()
    assert len(store.download_raw_paths()) == 1        # flushes
    assert where.exists() and store.download_count == 4
    assert len(store.list_download()) == 4
