"""Port parity: the DFC1 columnar files, the reference-CSV codec and the
synthetic generators, ``dragonfly2_tpu_torch/records/{columnar,csv_compat,
synthetic}.py`` against ``dragonfly2_tpu/records/``.

All numpy and the standard library on both sides, so every comparison is
exact: equal bytes on disk, bit-equal arrays, equal records (compared as
``schema.to_dict`` trees, with the generators' clock and peer-id uuid
pinned).
"""

from __future__ import annotations

import uuid

import numpy as np
import pytest

from dragonfly2_tpu.records import columnar as jcol
from dragonfly2_tpu.records import csv_compat as jcsv
from dragonfly2_tpu.records import schema as jschema
from dragonfly2_tpu.records import synthetic as jsyn
from dragonfly2_tpu_torch.records import columnar as tcol
from dragonfly2_tpu_torch.records import csv_compat as tcsv
from dragonfly2_tpu_torch.records import schema as tschema
from dragonfly2_tpu_torch.records import synthetic as tsyn
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, TOPO_COLUMNS

NOW = 1_760_000_000_000_000_000


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    """The record generators stamp ``now_ns()`` and peer ids carry a
    ``uuid4``: pin both."""
    monkeypatch.setattr(jsyn, "now_ns", lambda: NOW)
    monkeypatch.setattr(tsyn, "now_ns", lambda: NOW)
    fixed = uuid.UUID(int=0x5EED)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)


def _rows(n=333, seed=0):
    return np.random.default_rng(seed).standard_normal((n, len(DOWNLOAD_COLUMNS))).astype(
        np.float32)


def test_magic_equals_the_jax_abi_constant():
    assert tcol.MAGIC == jcol.MAGIC == b"DFC1"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_files_are_byte_identical_and_read_across(tmp_path, dtype):
    rows = _rows().astype(dtype)
    paths = {}
    for name, mod in (("jax", jcol), ("port", tcol)):
        paths[name] = str(tmp_path / f"{name}.dfc")
        with mod.ColumnarWriter(paths[name], DOWNLOAD_COLUMNS, dtype=dtype) as w:
            w.append(rows[:100])
            w.append(rows[100])            # one row, [ncols]
            w.append(rows[101:])
            assert w.tell_rows() == len(rows)
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["jax"] == raw["port"]
    # Each package reads the other's file, bit for bit.
    for reader, path in ((tcol, paths["jax"]), (jcol, paths["port"])):
        r = reader.ColumnarReader(path)
        assert r.columns == tuple(DOWNLOAD_COLUMNS) and len(r) == len(rows)
        assert np.array_equal(r.to_array(), rows)
        got = np.concatenate(list(r.batches(64, drop_remainder=True)))
        assert np.array_equal(got, rows[: (len(rows) // 64) * 64])
    assert np.array_equal(tcol.concat_readers([paths["jax"], paths["port"]]),
                          jcol.concat_readers([paths["jax"], paths["port"]]))
    (th, t_off), (jh, j_off) = tcol.read_header(paths["jax"]), jcol.read_header(paths["port"])
    assert (th.columns, th.dtype, th.created_at_ns, t_off) == (
        jh.columns, jh.dtype, jh.created_at_ns, j_off)


def test_append_to_an_existing_file_and_column_mismatch(tmp_path):
    path = str(tmp_path / "a.dfc")
    rows = _rows(20)
    with jcol.ColumnarWriter(path, DOWNLOAD_COLUMNS) as w:
        w.append(rows[:5])
    with tcol.ColumnarWriter(path, DOWNLOAD_COLUMNS) as w:
        w.append(rows[5:])
    assert np.array_equal(jcol.ColumnarReader(path).to_array(), rows)
    for mod in (jcol, tcol):
        with pytest.raises(ValueError, match="existing columns"):
            mod.ColumnarWriter(path, TOPO_COLUMNS)


@pytest.mark.parametrize("cut", ["magic", "length", "header", "json"])
def test_malformed_prefixes_raise_the_same_error(tmp_path, cut):
    path = str(tmp_path / "ok.dfc")
    with tcol.ColumnarWriter(path, DOWNLOAD_COLUMNS) as w:
        w.append(_rows(3))
    raw = open(path, "rb").read()
    bad = {"magic": b"XXXX" + raw[4:], "length": raw[:6], "header": raw[:20],
           "json": raw[:8] + b"{" * (len(raw) - 8)}[cut]
    open(path, "wb").write(bad)
    msgs = []
    for mod in (jcol, tcol):
        with pytest.raises(ValueError) as exc:
            mod.read_header(path)
        msgs.append(str(exc.value).split(":")[1])
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("chunk", [1, 7, 13, 131, 135, 1000, 1 << 20])
def test_streaming_decoder_in_odd_chunks_matches(tmp_path, chunk):
    rows = _rows(57, seed=3)
    path = str(tmp_path / "s.dfc")
    with tcol.ColumnarWriter(path, DOWNLOAD_COLUMNS) as w:
        w.append(rows)
    raw = open(path, "rb").read()
    out = {}
    for name, mod in (("jax", jcol), ("port", tcol)):
        dec = mod.StreamingRowDecoder()
        parts = [dec.feed(raw[i:i + chunk]) for i in range(0, len(raw), chunk)]
        got = np.concatenate([p for p in parts if p.size] or [np.zeros((0, rows.shape[1]))])
        assert dec.rows_decoded == len(rows)
        out[name] = got
    assert np.array_equal(out["jax"], rows) and np.array_equal(out["port"], rows)


def test_synthetic_vectorized_generators_are_bit_equal():
    jc, tc = jsyn.SyntheticCluster(num_hosts=300, seed=7), tsyn.SyntheticCluster(num_hosts=300, seed=7)
    assert np.array_equal(jc.generate_feature_rows(500, seed=4), tc.generate_feature_rows(500, seed=4))
    # The shared generator, then a drift, then the same again.
    assert np.array_equal(jc.generate_feature_rows(200), tc.generate_feature_rows(200))
    jc.drift(np.random.default_rng(9))
    tc.drift(np.random.default_rng(9))
    for attr in ("concurrent_uploads", "cpu_load", "mem_load", "upload_count",
                 "upload_failed", "upload_conns"):
        assert np.array_equal(getattr(jc, attr), getattr(tc, attr)), attr
    assert np.array_equal(jc.generate_feature_rows(200), tc.generate_feature_rows(200))
    assert np.array_equal(jc._bucket_table(), tc._bucket_table())
    a, b = np.arange(300), np.arange(300)[::-1]
    assert np.array_equal(jc._location_affinity_vec(a, b), tc._location_affinity_vec(a, b))
    assert jschema.to_dict(jc.host_record(5)) == tschema.to_dict(tc.host_record(5))
    assert jschema.to_dict(jc.topo_host(6, 123)) == tschema.to_dict(tc.topo_host(6, 123))


def test_synthetic_records_are_equal():
    jc, tc = jsyn.SyntheticCluster(num_hosts=64, seed=2), tsyn.SyntheticCluster(num_hosts=64, seed=2)
    jd, td = jc.generate_downloads(25), tc.generate_downloads(25)
    assert [jschema.to_dict(d) for d in jd] == [tschema.to_dict(d) for d in td]
    jt, tt = jc.generate_topology_records(25), tc.generate_topology_records(25)
    assert [jschema.to_dict(t) for t in jt] == [tschema.to_dict(t) for t in tt]
    # One shared generator: the next draws agree too.
    assert np.array_equal(jc.generate_feature_rows(50), tc.generate_feature_rows(50))


@pytest.mark.parametrize("value", [0.0, 1.0, -2.5, 123456.78, 1e6, 8589934592.0, 1.5e-5,
                                   0.0001, 0.00012345, 3.0e21, -7.25e-9, float("inf"),
                                   float("-inf"), float("nan"), 0.1 + 0.2, 999999.0])
def test_go_float_formatting_matches(value):
    assert tcsv._go_float(value) == jcsv._go_float(value)


@pytest.mark.parametrize("kind", ["download", "topology"])
def test_reference_csv_converts_to_identical_dfc1_bytes(tmp_path, kind):
    cluster = jsyn.SyntheticCluster(num_hosts=40, seed=1)
    if kind == "download":
        records = cluster.generate_downloads(12)
        write = {"jax": jcsv.write_download_csv, "port": tcsv.write_download_csv}
        convert = {"jax": jcsv.convert_download_csv_to_columnar,
                   "port": tcsv.convert_download_csv_to_columnar}
        parse = {"jax": jcsv.parse_download_csv_bytes, "port": tcsv.parse_download_csv_bytes}
    else:
        records = cluster.generate_topology_records(12)
        write = {"jax": jcsv.write_topology_csv, "port": tcsv.write_topology_csv}
        convert = {"jax": jcsv.convert_topology_csv_to_columnar,
                   "port": tcsv.convert_topology_csv_to_columnar}
        parse = {"jax": jcsv.parse_topology_csv_bytes, "port": tcsv.parse_topology_csv_bytes}
    text, dfc = {}, {}
    for name in ("jax", "port"):
        csv_path = str(tmp_path / f"{name}.csv")
        assert write[name](records, csv_path) == 12
        text[name] = open(csv_path, "rb").read()
        out = str(tmp_path / f"{name}.dfc")
        assert convert[name](csv_path, out) > 0
        dfc[name] = open(out, "rb").read()
    assert text["jax"] == text["port"]
    assert dfc["jax"] == dfc["port"]
    assert ([jschema.to_dict(r) for r in parse["jax"](text["jax"])]
            == [tschema.to_dict(r) for r in parse["port"](text["port"])])
