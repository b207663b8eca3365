"""Stress: concurrent download load generator with latency statistics.

Reference: test/tools/stress/main.go — fires concurrent downloads and
reports throughput + latency percentiles.  Drives any conductor-shaped
downloader (embedded daemon, wire node) against a task catalog.

Library + CLI:  ``python -m dragonfly2_tpu_torch.tools.stress --help``.

Port of ``dragonfly2_tpu/tools/stress.py``, verbatim: ``main`` drives the
port's daemon parts (storage, upload server, conductor) against a port
scheduler's URL.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class StressReport:
    total: int = 0
    succeeded: int = 0
    failed: int = 0
    bytes: int = 0
    wall_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)

    @property
    def throughput_mbps(self) -> float:
        return self.bytes / max(self.wall_s, 1e-9) / 1e6

    @property
    def rps(self) -> float:
        return self.succeeded / max(self.wall_s, 1e-9)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile: ceil(p/100 * n) - 1 (p99 of 100 samples
        is the 99th value, not the max)."""
        if not self.latencies_s:
            return 0.0
        data = sorted(self.latencies_s)
        import math

        idx = max(math.ceil(p / 100.0 * len(data)) - 1, 0)
        return data[min(idx, len(data) - 1)]

    def summary(self) -> Dict:
        return {
            "total": self.total,
            "succeeded": self.succeeded,
            "failed": self.failed,
            "throughput_MBps": round(self.throughput_mbps, 2),
            "downloads_per_sec": round(self.rps, 2),
            "latency_p50_ms": round(self.percentile(50) * 1e3, 2),
            "latency_p95_ms": round(self.percentile(95) * 1e3, 2),
            "latency_p99_ms": round(self.percentile(99) * 1e3, 2),
        }


def run_stress(
    download: Callable[[str], "object"],
    urls: List[str],
    *,
    concurrency: int = 8,
    total: int = 100,
) -> StressReport:
    """Fire ``total`` downloads over ``urls`` with ``concurrency`` workers.

    ``download(url)`` must return an object with ``ok`` and ``bytes``
    attributes (DownloadResult-shaped).
    """
    if not urls:
        raise ValueError("run_stress needs at least one url")
    report = StressReport(total=total)
    lock = threading.Lock()
    counter = {"i": 0}

    def worker() -> None:
        while True:
            with lock:
                if counter["i"] >= total:
                    return
                i = counter["i"]
                counter["i"] += 1
            url = urls[i % len(urls)]
            t0 = time.perf_counter()
            try:
                result = download(url)
                ok = bool(getattr(result, "ok", False))
                nbytes = int(getattr(result, "bytes", 0))
            except Exception as exc:  # noqa: BLE001 — load-gen counts failures
                logging.getLogger(__name__).debug("download %s failed: %s", url, exc)
                ok, nbytes = False, 0
            dt = time.perf_counter() - t0
            with lock:
                if ok:
                    report.succeeded += 1
                    report.bytes += nbytes
                    report.latencies_s.append(dt)
                else:
                    report.failed += 1

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=worker, daemon=True) for _ in range(concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        # Bounded join loop (DF008 timeout sweep): a hung worker shows up
        # in watchdog stack dumps rather than freezing the run silently.
        while t.is_alive():
            t.join(5.0)
    report.wall_s = time.perf_counter() - t0
    return report


def main(argv: Optional[list] = None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser("stress", description="P2P download load generator")
    p.add_argument("--scheduler", required=True, help="scheduler RPC URL")
    p.add_argument("--url", action="append", required=True, help="source URL (repeatable)")
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--total", type=int, default=100)
    p.add_argument("--piece-size", type=int, default=4 << 20)
    p.add_argument("--work-dir", default=None)
    args = p.parse_args(argv)

    import tempfile

    from ..daemon import DaemonStorage, UploadManager
    from ..daemon.conductor import Conductor
    from ..rpc import HTTPPieceFetcher, PieceHTTPServer, RemoteScheduler
    from ..scheduler.resource import Host
    from ..source import PieceSourceFetcher
    from ..utils import idgen

    work = args.work_dir or tempfile.mkdtemp(prefix="stress-")
    storage = DaemonStorage(work)
    upload = UploadManager(storage)
    piece_server = PieceHTTPServer(upload)
    piece_server.serve()
    host = Host(
        id=idgen.host_id_v2("127.0.0.1", f"stress-{piece_server.port}"),
        hostname="stress",
        ip="127.0.0.1",
        download_port=piece_server.port,
    )
    client = RemoteScheduler(args.scheduler)
    source = PieceSourceFetcher()
    conductor = Conductor(
        host, storage, client,
        piece_fetcher=HTTPPieceFetcher(client.resolve_host),
        source_fetcher=source,
    )

    def download(url: str):
        content_length = source.content_length(url)
        if content_length < 0:
            # -1 would yield a fake 0-piece "success" — fail the sample.
            raise IOError(f"cannot size {url}")
        return conductor.download(
            url, piece_size=args.piece_size, content_length=content_length
        )

    report = run_stress(
        download, args.url, concurrency=args.concurrency, total=args.total
    )
    print(json.dumps(report.summary()))
    piece_server.stop()
    return 0 if report.failed == 0 else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
