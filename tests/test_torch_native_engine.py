"""Port parity: the port's native host engine (``dragonfly2_tpu_torch/
native``), built from its own ``native.cpp`` into
``build/dragonfly2_tpu_torch_native/`` on first use.

- The piece store: the port's ``NativePieceStore`` and the JAX package's
  write the same task, and each package's native store reloads the
  other's task byte for byte; the port's native store and its Python
  store reload each other's tasks.
- The DFC1 writer: ``NativeColumnarWriter`` shards equal the port's
  Python ``ColumnarWriter``'s byte for byte, read back row for row by the
  port's reader and the JAX package's; record ``Storage`` writes through
  the native writer at its defaults.
- The ABI witness (the port's counterpart of the live half of
  ``tests/test_zz_abiwitness.py``): the library's ``df_abi_manifest()``
  byte-matches the port's ``records/abi_contracts.py``, the sentinel
  ``FetchDone`` round-trips, and the stats out-pointers keep the
  registry's order through a real serve.
- ``native_test.cpp``, the engine's concurrency self-test, builds into
  the build directory, runs and prints its OK marker.

No case skips: the library must build here.
"""

from __future__ import annotations

import json
import os
import subprocess
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import dragonfly2_tpu.daemon.storage as j_storage
import dragonfly2_tpu.native as j_native
import dragonfly2_tpu.records.columnar as j_columnar
import dragonfly2_tpu_torch.daemon.storage as t_storage
import dragonfly2_tpu_torch.native as t_native
import dragonfly2_tpu_torch.records.columnar as t_columnar
from dragonfly2_tpu_torch.records import abi_contracts
from dragonfly2_tpu_torch.utils import dfabi

REPO = Path(__file__).resolve().parents[1]
PIECE = 32 * 1024
TASK = "f" * 64


def _pieces(seed, n=5, last=PIECE - 123):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, PIECE if i < n - 1 else last, dtype=np.uint8).tobytes()
            for i in range(n)]


def _write(storage, pieces, numbers=None):
    storage.register_task(TASK, piece_size=PIECE,
                          content_length=PIECE * (len(pieces) - 1) + len(pieces[-1]))
    for n in numbers if numbers is not None else range(len(pieces)):
        storage.write_piece(TASK, n, pieces[n])


def _reload(storage):
    assert storage.reload_persistent_tasks(storage.scan_disk_tasks()) == [TASK]
    return storage


def test_the_library_builds_under_the_build_directory():
    assert t_native.available(), t_native.build_error()
    assert t_native.build_error() is None
    build = REPO / "build" / "dragonfly2_tpu_torch_native"
    assert t_native.lib_path is not None and t_native.lib_path.parent == build
    assert t_native.lib_path == t_native.library_target()
    # Keyed by the source's hash; nothing built into the package.
    assert t_native.lib_path.name.startswith("libdragonfly_native_")
    assert not list((REPO / "dragonfly2_tpu_torch" / "native").glob("*.so"))


STORES = {
    "torch-native": lambda root: t_storage.DaemonStorage(root, prefer_native=True),
    "jax-native": lambda root: j_storage.DaemonStorage(root, prefer_native=True),
    "torch-python": lambda root: t_storage.DaemonStorage(root, prefer_native=False),
}
PAIRS = [("torch-native", "jax-native"), ("jax-native", "torch-native"),
         ("torch-native", "torch-python"), ("torch-python", "torch-native")]


@pytest.mark.parametrize("writer,reader", PAIRS, ids=[f"{w}->{r}" for w, r in PAIRS])
def test_each_store_reloads_the_others_task(tmp_path, writer, reader):
    """A partial task (pieces 0, 2, 4 of 5) written by one engine reloads
    in the other with the same bitmap, bytes and crc-checked reads; the
    reader then completes it and the writer reloads the whole task."""
    root = str(tmp_path / "store")
    pieces = _pieces(3)
    w = STORES[writer](root)
    assert w.is_native == writer.endswith("native")
    _write(w, pieces, numbers=[0, 2, 4])
    w.engine.close()

    r = _reload(STORES[reader](root))
    assert r.is_native == reader.endswith("native")
    assert r.held_pieces(TASK) == 3
    assert list(r.engine.piece_bitmap(TASK, 5)) == [1, 0, 1, 0, 1]
    for n in (0, 2, 4):
        assert r.read_piece(TASK, n) == pieces[n], n
    for n in (1, 3):
        r.write_piece(TASK, n, pieces[n])
    r.engine.close()

    w2 = _reload(STORES[writer](root))
    assert w2.held_pieces(TASK) == 5
    assert w2.read_task_bytes(TASK) == b"".join(pieces)
    w2.engine.close()


def test_native_stores_write_the_same_files(tmp_path):
    """The two packages' native stores lay one task out byte for byte."""
    pieces = _pieces(5)
    roots = {}
    for name in ("torch-native", "jax-native"):
        roots[name] = tmp_path / name
        st = STORES[name](str(roots[name]))
        _write(st, pieces)
        st.engine.close()

    def files(root):
        return {str(p.relative_to(root)): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}

    assert files(roots["torch-native"]) == files(roots["jax-native"])


@pytest.mark.parametrize("chunks", [[100], [1, 37, 250, 0, 12]], ids=["one", "several"])
def test_native_dfc1_writer_equals_python_writer(tmp_path, chunks):
    columns = [f"c{i}" for i in range(11)]
    rng = np.random.default_rng(len(chunks))
    rows = rng.standard_normal((sum(chunks), len(columns))).astype(np.float32)
    paths = {"native": str(tmp_path / "n.dfc"), "python": str(tmp_path / "p.dfc")}
    for kind, cls in (("native", t_native.NativeColumnarWriter),
                      ("python", t_columnar.ColumnarWriter)):
        at = 0
        with cls(paths[kind], columns) as w:
            for n in chunks:
                if n:
                    w.append(rows[at:at + n])
                at += n
            assert w.tell_rows() == len(rows)
    with open(paths["native"], "rb") as f, open(paths["python"], "rb") as g:
        assert f.read() == g.read()
    for reader in (t_columnar.ColumnarReader, j_columnar.ColumnarReader):
        r = reader(paths["native"])
        assert len(r) == len(rows)
        np.testing.assert_array_equal(r.to_array(), rows)
    # Appending to an existing shard keeps its header and its columns.
    with t_native.NativeColumnarWriter(paths["native"], columns) as w:
        w.append(rows[:3])
    assert len(t_columnar.ColumnarReader(paths["native"])) == len(rows) + 3
    with pytest.raises(ValueError, match="existing columns"):
        t_native.NativeColumnarWriter(paths["native"], columns[:-1])


def test_record_storage_writes_through_the_native_writer(tmp_path, monkeypatch):
    from dragonfly2_tpu_torch.records import storage as record_storage
    from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster

    made = []
    original = record_storage._make_columnar_writer
    monkeypatch.setattr(record_storage, "_make_columnar_writer",
                        lambda p, c: made.append(original(p, c)) or made[-1])
    storage = record_storage.Storage(str(tmp_path / "records"), buffer_size=8)
    cluster = SyntheticCluster(num_hosts=32, seed=0)
    for rec in cluster.generate_downloads(20):
        storage.create_download(rec)
    storage.flush()
    assert made and all(isinstance(w, t_native.NativeColumnarWriter) for w in made)
    (path,) = storage.download_columnar_paths()
    rows = t_columnar.ColumnarReader(path)
    assert len(rows) > 0 and len(rows) == len(j_columnar.ColumnarReader(path))


class TestAbiWitness:
    def test_live_manifest_byte_matches_registry(self):
        live = dfabi.live_manifest_bytes()
        assert live is not None, "df_abi_manifest missing from the library"
        assert dfabi.compare() == []
        assert live == abi_contracts.manifest_json().encode()

    def test_sentinel_fetchdone_round_trips(self):
        got = dfabi.probe_fetchdone()
        assert got is not None
        size = got.pop("__returned_size__")
        assert size == abi_contracts.record_size("FetchDone") == 24
        assert got == dfabi.PROBE_SENTINEL
        assert got["status"] == abi_contracts.constant("kFetchStatusProto")

    def test_shared_constants_read_from_the_registry(self):
        from dragonfly2_tpu_torch.rpc import piece_transport

        assert piece_transport.LONG_POLL_MAX_MS == abi_contracts.constant("kLongPollMaxMs")
        assert t_columnar.MAGIC == abi_contracts.constant("kMagic").encode()
        assert (t_native.BATCH_MAX, t_native.FETCH_BURST_MAX, t_native.MAX_FETCH_BODY) == (
            abi_contracts.constant("kBatchMax"), abi_contracts.constant("kFetchBurstMax"),
            abi_contracts.constant("kMaxFetchBody"))
        # The port's registry is the reference's but for its file names.
        assert abi_contracts.expected_manifest() == json.loads(
            dfabi.live_manifest_bytes().decode())
        from dragonfly2_tpu.records import abi_contracts as j_abi

        assert abi_contracts.manifest_json() == j_abi.manifest_json()

    def test_doctored_manifest_named(self):
        doctored = json.loads(abi_contracts.manifest_json())
        doctored["constants"]["kBatchMax"] += 1
        gaps = dfabi.compare(live_bytes=json.dumps(
            doctored, sort_keys=True, separators=(",", ":")).encode())
        assert any("kBatchMax" in g for g in gaps)

    def test_serve_stats_full_order_through_real_serve(self, tmp_path):
        """``ps_serve_stats2``'s out-pointers in the registry's order:
        two pieces served through the engine show up as pieces, bytes."""
        store = t_native.NativePieceStore(str(tmp_path / "s"))
        store.create_task(TASK, PIECE, 2 * PIECE)
        for n in range(2):
            store.write_piece(TASK, n, bytes([n + 1]) * PIECE)
        port = store.serve("127.0.0.1", 0)
        try:
            for n in range(2):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/pieces/{TASK}/{n}", timeout=5) as resp:
                    assert resp.read() == bytes([n + 1]) * PIECE
            full = store.serve_stats_full()
            assert list(full) == abi_contracts.ABI_CONTRACTS["stats_fields"][
                "ps_serve_stats2"]["fields"]
            assert (full["pieces"], full["bytes"]) == (2, 2 * PIECE)
        finally:
            store.serve_stop()
            store.close()
        assert t_native.leaked_servers() == (0, 0)


def test_native_self_test_builds_and_passes(tmp_path):
    binary = t_native.build_self_test("plain")
    assert binary.parent == REPO / "build" / "dragonfly2_tpu_torch_native"
    proc = subprocess.run([str(binary)], capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "native_test: OK" in proc.stdout
