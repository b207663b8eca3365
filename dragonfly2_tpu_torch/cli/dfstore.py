"""dfstore: object-storage CLI through the P2P gateway (reference:
cmd/dfstore + client/dfstore — Get/Put/Copy/Delete/IsExist + metadata).

Port of ``dragonfly2_tpu/cli/dfstore.py``, verbatim.
"""

from __future__ import annotations

import os
import sys

from ..daemon import Daemon
from ..daemon.gateway import GatewayConfig, GatewaySourceFetcher, ObjectGateway
from ..objectstorage import FilesystemBackend
from ..scheduler import Evaluator, Resource, SchedulerService, Scheduling, SchedulingConfig
from ..scheduler.resource import Host
from ..utils import idgen
from .common import base_parser, init_debug, init_logging


def _gateway(args):
    # Backend by config (objectstorage.go:179-212 dispatch): local
    # filesystem by default; signed S3/OSS endpoints when pointed at one.
    from ..objectstorage import make_backend

    if args.backend == "fs":
        backend = FilesystemBackend(args.backend_root)
    else:
        backend = make_backend(
            args.backend, endpoint=args.endpoint,
            access_key=args.access_key, secret_key=args.secret_key,
            region=args.region,
        )
    resource = Resource()
    scheduler = SchedulerService(
        resource, Scheduling(Evaluator(), SchedulingConfig(retry_interval=0))
    )
    import socket

    hostname = socket.gethostname()
    host = Host(id=idgen.host_id_v2("127.0.0.1", hostname), hostname=hostname, ip="127.0.0.1")
    resource.store_host(host)
    daemon = Daemon(
        host,
        scheduler,
        storage_root=os.path.join(args.work_dir, "pieces"),
        source_fetcher=GatewaySourceFetcher(backend),
    )
    return ObjectGateway(daemon, backend, GatewayConfig(bucket=args.bucket))


def run(argv=None) -> int:
    p = base_parser("dfstore", "Object storage through the P2P gateway")
    p.add_argument("command", choices=["put", "get", "stat", "rm", "ls", "cp"])
    p.add_argument("key", nargs="?", default="")
    p.add_argument("dst_key", nargs="?", default="", help="destination key (cp)")
    p.add_argument("-f", "--file", default=None, help="local file (put/get)")
    p.add_argument("--bucket", default="dragonfly")
    p.add_argument("--backend", choices=["fs", "s3", "oss", "obs"],
                   default="fs",
                   help="object-storage backend (fs=local dir, "
                        "s3/oss/obs=remote)")
    p.add_argument("--endpoint", default="",
                   help="s3/oss endpoint URL (e.g. http://minio:9000)")
    p.add_argument("--access-key", default=os.environ.get("DF_ACCESS_KEY", ""))
    p.add_argument("--secret-key", default=os.environ.get("DF_SECRET_KEY", ""))
    p.add_argument("--region", default="us-east-1")
    p.add_argument("--backend-root", default=os.path.expanduser("~/.dragonfly/objects"))
    p.add_argument("--work-dir", default=os.path.expanduser("~/.dragonfly/dfstore"))
    args = p.parse_args(argv)
    init_logging(args, "dfstore")
    init_debug(args)
    if args.backend != "fs" and not args.endpoint:
        p.error(f"--backend {args.backend} requires --endpoint")
    gw = _gateway(args)

    if args.command == "put":
        if not args.file or not args.key:
            print("dfstore: put needs KEY and -f FILE", file=sys.stderr)
            return 1
        with open(args.file, "rb") as f:
            meta = gw.put_object(args.key, f.read())
        print(f"dfstore: put {args.key} ({meta.content_length} bytes, etag {meta.etag[:12]})")
        return 0
    if args.command == "get":
        if not args.file or not args.key:
            print("dfstore: get needs KEY and -f FILE", file=sys.stderr)
            return 1
        data = gw.get_object(args.key)
        with open(args.file, "wb") as f:
            f.write(data)
        print(f"dfstore: got {args.key} ({len(data)} bytes) -> {args.file}")
        return 0
    if args.command == "stat":
        if not gw.object_exists(args.key):
            print(f"dfstore: {args.key} not found", file=sys.stderr)
            return 1
        m = gw.head_object(args.key)
        print(f"dfstore: {m.key} length={m.content_length} etag={m.etag}")
        return 0
    if args.command == "rm":
        gw.delete_object(args.key)
        print(f"dfstore: removed {args.key}")
        return 0
    if args.command == "cp":
        m = gw.copy_object(args.key, args.dst_key)
        print(f"dfstore: copied {args.key} -> {m.key}")
        return 0
    # ls
    for m in gw.list_objects(args.key):
        print(f"{m.content_length:>12} {m.key}")
    return 0


if __name__ == "__main__":
    sys.exit(run())
