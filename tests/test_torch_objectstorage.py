"""Port parity: object storage and the daemon's object gateway,
``dragonfly2_tpu_torch/objectstorage/`` and ``daemon/gateway.py``, with
``cli/{dfstore,dfcache}.py``, against the JAX package's.

- The filesystem backend's CRUD and its path-traversal refusal
  (``tests/test_breadth.py``'s ``TestFilesystemBackend``).
- The S3, OSS and OBS backends send byte-equal requests (method, URL,
  headers with their signatures, body) to one recording fake as the JAX
  package's, with the clock frozen, over the same operations; the fake
  recomputes every signature (``tests/fake_s3.py``: SigV4 and OBS; OSS
  through ``source/oss.sign_oss`` with the ``x-oss-`` prefix), and the
  port counterparts of ``tests/test_objectstorage_s3.py:47-227`` run on
  it.  The manager's bucket routes (``:238``) drive the port's S3
  backend on the fake, and 404 on a manager with none.
- The gateway: a put seeds P2P, a peer's get comes from the swarm, a
  delete evicts the pieces, and the same over the S3 backend.
- ``dfstore`` and ``dfcache`` print the reference's lines for the same
  commands (``tests/test_platform.py:180``).
"""

from __future__ import annotations

import email.utils
import os
import time
import types
import urllib.request

import pytest

import dragonfly2_tpu.objectstorage as jos
import dragonfly2_tpu.objectstorage.s3 as js3
import dragonfly2_tpu_torch.objectstorage as tos
import dragonfly2_tpu_torch.objectstorage.s3 as ts3
from dragonfly2_tpu_torch.daemon.gateway import GatewayConfig, GatewaySourceFetcher, ObjectGateway
from dragonfly2_tpu_torch.source.oss import sign_oss
from tests.fake_s3 import ACCESS_KEY, REGION, SECRET_KEY, FakeS3
from test_torch_daemon import PIECE, _Swarm

FROZEN = time.gmtime(1_760_000_000)


# -- the filesystem backend -----------------------------------------------


def test_filesystem_crud(tmp_path):
    b = tos.FilesystemBackend(str(tmp_path))
    b.create_bucket("bkt")
    meta = b.put_object("bkt", "a/b/key.bin", b"hello")
    assert meta.content_length == 5
    assert b.get_object("bkt", "a/b/key.bin") == b"hello"
    assert b.object_exists("bkt", "a/b/key.bin")
    b.copy_object("bkt", "a/b/key.bin", "copy.bin")
    keys = [m.key for m in b.list_objects("bkt")]
    assert sorted(keys) == ["a/b/key.bin", "copy.bin"]
    assert [m.key for m in b.list_objects("bkt", prefix="a/")] == ["a/b/key.bin"]
    b.delete_object("bkt", "copy.bin")
    assert not b.object_exists("bkt", "copy.bin")
    with pytest.raises(KeyError):
        b.get_object("bkt", "missing")


def test_filesystem_path_traversal_rejected(tmp_path):
    b = tos.FilesystemBackend(str(tmp_path))
    b.create_bucket("bkt")
    with pytest.raises(ValueError):
        b.put_object("bkt", "../escape", b"x")
    with pytest.raises(ValueError):
        b.create_bucket("../up")


def test_filesystem_backends_write_the_same_tree(tmp_path):
    """Either package reads what the other wrote, with equal metadata."""
    j = jos.FilesystemBackend(str(tmp_path / "store"))
    t = tos.FilesystemBackend(str(tmp_path / "store"))
    j.create_bucket("bkt")
    j.put_object("bkt", "from/jax", b"j" * 33)
    t.put_object("bkt", "from/port", b"t" * 44)
    assert t.get_object("bkt", "from/jax") == b"j" * 33
    assert j.get_object("bkt", "from/port") == b"t" * 44
    strip = lambda ms: [(m.key, m.content_length, m.etag) for m in ms]  # noqa: E731
    assert strip(t.list_objects("bkt")) == strip(j.list_objects("bkt"))
    for name in ("fs",):
        assert type(tos.default_backends(str(tmp_path / "d")).get(name)).__name__ == \
            type(jos.default_backends(str(tmp_path / "d")).get(name)).__name__


# -- the signed HTTP backends ---------------------------------------------


def _oss_fake():
    """``FakeS3`` verifying the OSS header scheme (``x-oss-`` headers, an
    ``OSS`` label) through the port's ``sign_oss``."""
    fake = FakeS3(auth="obs")
    base = fake._httpd.RequestHandlerClass

    class OSSHandler(base):
        def _check_sig(self, payload):
            bucket, key, _ = self._route()
            expect = sign_oss(
                SECRET_KEY, self.command, date=self.headers.get("Date", ""),
                bucket=bucket, key=key, content_type=self.headers.get("Content-Type", ""),
                oss_headers=dict(self.headers), resource=None if bucket else "/",
                header_prefix="x-oss-")
            ok = self.headers.get("Authorization", "") == f"OSS {ACCESS_KEY}:{expect}"
            if not ok:
                fake.auth_failures += 1
            return ok

    fake._httpd.RequestHandlerClass = OSSHandler
    return fake


FAKES = {"s3": lambda: FakeS3(), "oss": _oss_fake, "obs": lambda: FakeS3(auth="obs")}


def _backend(mod, kind, endpoint):
    kw = dict(endpoint=endpoint, access_key=ACCESS_KEY, secret_key=SECRET_KEY)
    if kind == "s3":
        kw["region"] = REGION
    return mod.make_backend(kind, **kw)


def _operations(b, kind):
    out = [b.bucket_exists("bkt")]
    b.create_bucket("bkt")
    b.create_bucket("bkt")
    out.append(b.bucket_exists("bkt"))
    meta = b.put_object("bkt", "a/b/model.npz", b"\x00\x01payload")
    out.append((meta.content_length, meta.etag))
    b.put_object("bkt", "x/two", b"2" * 20)
    out.append(b.get_object("bkt", "a/b/model.npz"))
    head = b.head_object("bkt", "a/b/model.npz")
    out.append((head.content_length, head.etag))
    out.append((b.object_exists("bkt", "a/b/model.npz"), b.object_exists("bkt", "ghost")))
    with pytest.raises(KeyError):
        b.get_object("bkt", "ghost")
    if kind != "oss":  # the fake copies from the S3 and OBS headers only
        out.append(b.copy_object("bkt", "a/b/model.npz", "x/copied").content_length)
    out.append([(m.key, m.content_length) for m in b.list_objects("bkt", prefix="x/")])
    out.append(sorted(b.list_buckets()))
    b.delete_object("bkt", "x/two")
    b.delete_object("bkt", "x/two")
    out.append(b.object_exists("bkt", "x/two"))
    return out


class _Recorder:
    def __init__(self, real):
        self.real = real
        self.requests = []

    def __call__(self, req, *args, **kwargs):
        self.requests.append((req.get_method(), req.full_url,
                              sorted((k.lower(), v) for k, v in req.header_items()),
                              req.data))
        return self.real(req, *args, **kwargs)


@pytest.fixture()
def frozen(monkeypatch):
    """Both packages' signers read one frozen clock."""
    class Clock:
        def gmtime(self, *a):
            return time.gmtime(*a) if a else FROZEN

        def __getattr__(self, name):
            return getattr(time, name)

    clock = Clock()
    fixed = email.utils.formatdate(time.mktime(FROZEN) - time.timezone, usegmt=True)
    utils = types.SimpleNamespace(formatdate=lambda *a, **k: fixed,
                                  parsedate_to_datetime=email.utils.parsedate_to_datetime)
    for mod in (js3, ts3):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "email", types.SimpleNamespace(utils=utils))
    recorder = _Recorder(urllib.request.urlopen)
    monkeypatch.setattr(urllib.request, "urlopen", recorder)
    return recorder


@pytest.mark.parametrize("kind", ["s3", "oss", "obs"])
def test_backends_send_byte_equal_requests(kind, frozen):
    fake = FAKES[kind]()
    try:
        results = {}
        sent = {}
        for name, mod in (("jax", js3), ("port", ts3)):
            fake.buckets.clear()
            frozen.requests.clear()
            results[name] = _operations(_backend(mod, kind, fake.endpoint), kind)
            sent[name] = list(frozen.requests)
        assert len(sent["port"]) >= 12
        assert sent["port"] == sent["jax"]
        assert results["port"] == results["jax"]
        assert fake.auth_failures == 0
        auth = dict(sent["port"][0][2])["authorization"]
        assert auth.startswith({"s3": "AWS4-HMAC-SHA256", "oss": f"OSS {ACCESS_KEY}:",
                                "obs": f"OBS {ACCESS_KEY}:"}[kind])
    finally:
        fake.stop()


@pytest.mark.parametrize("kind", ["s3", "obs"])
def test_bad_credentials_rejected(kind):
    fake = FAKES[kind]()
    try:
        kw = dict(endpoint=fake.endpoint, access_key=ACCESS_KEY, secret_key="wrong")
        if kind == "s3":
            kw["region"] = REGION
        with pytest.raises((ts3.ObjectStorageError, OSError)):
            ts3.make_backend(kind, **kw).create_bucket("nope")
        assert fake.auth_failures > 0
    finally:
        fake.stop()


def test_make_backend_dispatch(tmp_path):
    fs = ts3.make_backend("fs", root=str(tmp_path))
    fs.create_bucket("b")
    assert fs.bucket_exists("b")
    assert isinstance(ts3.make_backend("s3", endpoint="http://x"), ts3.S3Backend)
    assert isinstance(ts3.make_backend("oss", endpoint="http://x", access_key="a",
                                       secret_key="b"), ts3.OSSBackend)
    assert isinstance(ts3.make_backend("obs", endpoint="http://x"), ts3.OBSBackend)
    with pytest.raises(ValueError):
        ts3.make_backend("gcs", endpoint="http://x")


def test_oss_header_signature_shape():
    import base64
    import hashlib
    import hmac

    b = ts3.OSSBackend("http://oss.local", access_key="AK", secret_key="SK")
    headers = b._sign("PUT", "http://oss.local/bkt/key.bin",
                      {"x-oss-meta-tag": "v", "Content-Type": "application/json"},
                      b"payload", "bkt", "key.bin")
    date = headers["Date"]
    to_sign = "PUT\n\napplication/json\n" + date + "\nx-oss-meta-tag:v\n/bkt/key.bin"
    want = base64.b64encode(hmac.new(b"SK", to_sign.encode(), hashlib.sha1).digest()).decode()
    assert headers["Authorization"] == f"OSS AK:{want}"


# -- the gateway ----------------------------------------------------------


def test_put_seeds_p2p_and_peer_gets_from_swarm(tmp_path):
    swarm = _Swarm(tmp_path, n_hosts=3)
    backend = tos.FilesystemBackend(str(tmp_path / "objects"))
    gws = []
    for d in swarm.daemons[:2]:
        d.conductor.source_fetcher = GatewaySourceFetcher(backend)
        gws.append(ObjectGateway(d, backend, GatewayConfig(piece_size=PIECE)))
    payload = os.urandom(3 * PIECE + 100)
    gws[0].put_object("models/v1.bin", payload)
    assert gws[0].object_exists("models/v1.bin")
    assert gws[1].get_object("models/v1.bin") == payload
    assert swarm.daemons[0].upload.upload_count > 0


def test_delete_evicts_pieces(tmp_path):
    swarm = _Swarm(tmp_path, n_hosts=2)
    backend = tos.FilesystemBackend(str(tmp_path / "objects"))
    d = swarm.daemons[0]
    d.conductor.source_fetcher = GatewaySourceFetcher(backend)
    gw = ObjectGateway(d, backend, GatewayConfig(piece_size=PIECE))
    gw.put_object("k", b"x" * PIECE)
    tid = gw._task_id("k")
    assert d.storage.engine.piece_count(tid) == 1
    gw.delete_object("k")
    assert not gw.object_exists("k")
    assert d.storage.engine.piece_count(tid) == 0


def test_ranged_reads_over_the_in_flight_task(tmp_path):
    from dragonfly2_tpu_torch.utils.httprange import RangeNotSatisfiable

    swarm = _Swarm(tmp_path, n_hosts=2)
    backend = tos.FilesystemBackend(str(tmp_path / "objects"))
    gws = [ObjectGateway(d, backend, GatewayConfig(piece_size=PIECE)) for d in swarm.daemons]
    for d in swarm.daemons:
        d.conductor.source_fetcher = GatewaySourceFetcher(backend)
    blob = os.urandom(2 * PIECE + 17)
    gws[0].put_object("r/blob", blob)
    (start, end, total), chunks = gws[1].get_object_range("r/blob", "bytes=100-70000")
    assert (start, end, total) == (100, 70000, len(blob))
    assert b"".join(chunks) == blob[100:70001]
    with pytest.raises(RangeNotSatisfiable):
        gws[1].get_object_range("r/blob", f"bytes={len(blob) + 1}-")


def test_gateway_e2e_on_fake_s3(tmp_path):
    fake = FakeS3()
    try:
        s3 = ts3.S3Backend(fake.endpoint, access_key=ACCESS_KEY, secret_key=SECRET_KEY,
                           region=REGION)
        swarm = _Swarm(tmp_path, n_hosts=2)
        for d in swarm.daemons:
            d.conductor.source_fetcher = GatewaySourceFetcher(s3)
        gws = [ObjectGateway(d, s3, GatewayConfig(piece_size=PIECE)) for d in swarm.daemons]
        payload = bytes(i % 251 for i in range(2 * PIECE + 77))
        gws[0].put_object("models/ranker.npz", payload)
        assert s3.get_object("dragonfly", "models/ranker.npz") == payload
        assert gws[1].get_object("models/ranker.npz") == payload
        assert swarm.daemons[0].upload.upload_count > 0
        assert gws[1].head_object("models/ranker.npz").content_length == len(payload)
        assert [m.key for m in gws[1].list_objects("models/")] == ["models/ranker.npz"]
        gws[0].delete_object("models/ranker.npz")
        assert not gws[1].object_exists("models/ranker.npz")
        assert fake.auth_failures == 0
    finally:
        fake.stop()


# -- the binaries ---------------------------------------------------------


def _lines(run, argv, capsys, prefix):
    """(exit code, stdout lines, the binary's own stderr lines: log lines
    of the engine underneath are not the binary's)."""
    rc = run(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), [x for x in out.err.splitlines() if x.startswith(prefix)]


def test_dfstore_prints_the_reference_lines(tmp_path, capsys):
    from dragonfly2_tpu.cli.dfstore import run as jrun
    from dragonfly2_tpu_torch.cli.dfstore import run as trun

    src = tmp_path / "payload.bin"
    src.write_bytes(os.urandom(150_000))
    got = {}
    for name, run in (("jax", jrun), ("port", trun)):
        base = ["--work-dir", str(tmp_path / name / "work"),
                "--backend-root", str(tmp_path / name / "objects")]
        out_file = tmp_path / name / "out.bin"
        seq = [
            ["put", "m/a.bin", "-f", str(src)],
            ["stat", "m/a.bin"],
            ["cp", "m/a.bin", "m/b.bin"],
            ["ls", "m/"],
            ["get", "m/b.bin", "-f", str(out_file)],
            ["rm", "m/a.bin"],
            ["stat", "m/a.bin"],
            ["put", "m/c.bin"],
        ]
        got[name] = [_lines(run, cmd + base, capsys, "dfstore:") for cmd in seq]
        got[name][4] = (got[name][4][0], [x.replace(str(tmp_path / name), "DIR")
                                          for x in got[name][4][1]], got[name][4][2])
        assert out_file.read_bytes() == src.read_bytes()
    assert got["port"] == got["jax"]
    assert [rc for rc, _, _ in got["port"]] == [0, 0, 0, 0, 0, 0, 1, 1]


def test_dfcache_prints_the_reference_lines(tmp_path, capsys):
    from dragonfly2_tpu.cli.dfcache import run as jrun
    from dragonfly2_tpu_torch.cli.dfcache import run as trun

    src = tmp_path / "artifact.bin"
    payload = os.urandom(150_000)
    src.write_bytes(payload)
    got = {}
    for name, run in (("jax", jrun), ("port", trun)):
        # The store's parent exists, as in the reference's test: a missing
        # one makes either package's native store refuse the root.
        (tmp_path / name).mkdir()
        work = str(tmp_path / name / "cache")
        rc, out, err = _lines(run, ["import", str(src), "--work-dir", work,
                                    "--piece-size", "65536"], capsys, "dfcache:")
        cache_id = out[0].split(" as ")[1].split(" ")[0]
        restored = tmp_path / name / "restored.bin"
        got[name] = [(rc, out, err),
                     _lines(run, ["stat", cache_id, "--work-dir", work], capsys, "dfcache:"),
                     _lines(run, ["export", cache_id, "-O", str(restored), "--work-dir", work],
                            capsys, "dfcache:"),
                     _lines(run, ["stat", "missing-id", "--work-dir", work], capsys, "dfcache:")]
        got[name][2] = (got[name][2][0], [x.replace(str(restored), "OUT") for x in got[name][2][1]],
                        got[name][2][2])
        assert restored.read_bytes() == payload
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == [0, 0, 0, 1]


# -- the manager's bucket routes (tests/test_objectstorage_s3.py:238) -------


def test_manager_bucket_routes_proxy_backend():
    """handlers/bucket.go parity: the manager's bucket routes drive
    the configured object-storage backend."""
    import json
    import urllib.error

    from dragonfly2_tpu_torch.manager import ClusterManager, ModelRegistry
    from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer

    def call(base, method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            base + path, data=data,
            headers={"Content-Type": "application/json"}, method=method,
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read() or b"{}")

    fake_s3 = FakeS3()
    s3 = tos.S3Backend(fake_s3.endpoint, access_key=ACCESS_KEY, secret_key=SECRET_KEY,
                       region=REGION)
    try:
        server = ManagerRESTServer(
            ModelRegistry(), ClusterManager(), objectstorage=s3
        )
        server.serve()
        try:
            call(server.url, "POST", "/api/v1/buckets", {"name": "blobs"})
            assert s3.bucket_exists("blobs")
            got = call(server.url, "GET", "/api/v1/buckets")
            assert {"name": "blobs"} in got
            call(server.url, "POST", "/api/v1/buckets/blobs:delete", {})
            assert not s3.bucket_exists("blobs")
        finally:
            server.stop()
        # Unconfigured manager: the surface 404s cleanly.
        bare = ManagerRESTServer(ModelRegistry(), ClusterManager())
        bare.serve()
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                call(bare.url, "GET", "/api/v1/buckets")
            assert exc.value.code == 404
        finally:
            bare.stop()
    finally:
        fake_s3.stop()
