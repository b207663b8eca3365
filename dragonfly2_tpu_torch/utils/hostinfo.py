"""Live host statistics (reference: gopsutil usage in client/daemon/announcer
announcer.go:158-303 and scheduler/resource/host.go:133-347).

These stats ride every peer announce, land in Download training records
(scheduler/storage/types.go Host :59-126) and become the node features of
the trainer's peer graph — so the field set here defines the model's host
feature vector.
"""

from __future__ import annotations

import os
import platform
import socket
from dataclasses import dataclass, field, asdict
from typing import Optional


@dataclass
class CPUTimes:
    user: float = 0.0
    system: float = 0.0
    idle: float = 0.0
    nice: float = 0.0
    iowait: float = 0.0
    irq: float = 0.0
    softirq: float = 0.0
    steal: float = 0.0
    guest: float = 0.0


@dataclass
class CPUStat:
    logical_count: int = 0
    physical_count: int = 0
    percent: float = 0.0
    process_percent: float = 0.0
    times: CPUTimes = field(default_factory=CPUTimes)


@dataclass
class MemoryStat:
    total: int = 0
    available: int = 0
    used: int = 0
    used_percent: float = 0.0
    process_used_percent: float = 0.0
    free: int = 0


@dataclass
class NetworkStat:
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0
    location: str = ""
    idc: str = ""
    download_rate: float = 0.0
    download_rate_limit: float = 0.0
    upload_rate: float = 0.0
    upload_rate_limit: float = 0.0


@dataclass
class DiskStat:
    total: int = 0
    free: int = 0
    used: int = 0
    used_percent: float = 0.0
    inodes_total: int = 0
    inodes_used: int = 0
    inodes_free: int = 0
    inodes_used_percent: float = 0.0


@dataclass
class BuildInfo:
    git_version: str = ""
    git_commit: str = ""
    go_version: str = ""  # kept for record-schema parity; carries runtime version
    platform: str = ""


@dataclass
class HostInfo:
    ip: str = ""
    hostname: str = ""
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    cpu: CPUStat = field(default_factory=CPUStat)
    memory: MemoryStat = field(default_factory=MemoryStat)
    network: NetworkStat = field(default_factory=NetworkStat)
    disk: DiskStat = field(default_factory=DiskStat)
    build: BuildInfo = field(default_factory=BuildInfo)
    scheduler_cluster_id: int = 0
    announce_interval: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


def _read_meminfo() -> MemoryStat:
    stat = MemoryStat()
    try:
        with open("/proc/meminfo") as f:
            info = {}
            for line in f:
                key, _, rest = line.partition(":")
                info[key.strip()] = int(rest.strip().split()[0]) * 1024
        stat.total = info.get("MemTotal", 0)
        stat.free = info.get("MemFree", 0)
        stat.available = info.get("MemAvailable", stat.free)
        stat.used = max(stat.total - stat.available, 0)
        if stat.total:
            stat.used_percent = 100.0 * stat.used / stat.total
    except OSError:
        pass
    return stat


def _read_disk(path: str = "/") -> DiskStat:
    stat = DiskStat()
    try:
        st = os.statvfs(path)
        stat.total = st.f_blocks * st.f_frsize
        stat.free = st.f_bavail * st.f_frsize
        stat.used = stat.total - st.f_bfree * st.f_frsize
        if stat.total:
            stat.used_percent = 100.0 * stat.used / stat.total
        stat.inodes_total = st.f_files
        stat.inodes_free = st.f_favail
        stat.inodes_used = st.f_files - st.f_ffree
        if st.f_files:
            stat.inodes_used_percent = 100.0 * stat.inodes_used / st.f_files
    except OSError:
        pass
    return stat


class CPUSampler:
    """Delta-window CPU utilization (gopsutil-style): percent over the
    interval since THIS sampler's previous read, not the since-boot average.

    Each periodic caller owns a sampler so concurrent loops don't steal each
    other's windows; reads under a lock; a re-read before the jiffy counter
    advances returns the last computed percent instead of degrading to the
    since-boot average.
    """

    def __init__(self) -> None:
        import threading

        self._mu = threading.Lock()
        self._prev: Optional[tuple] = None
        self._last_percent: Optional[float] = None

    def read(self) -> CPUStat:
        stat = CPUStat(
            logical_count=os.cpu_count() or 0, physical_count=os.cpu_count() or 0
        )
        try:
            with open("/proc/stat") as f:
                first = f.readline().split()
        except OSError:
            return stat
        if not first or first[0] != "cpu":
            return stat
        vals = [float(v) for v in first[1:]]
        names = ["user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal", "guest"]
        for name, v in zip(names, vals):
            setattr(stat.times, name, v)
        busy = sum(vals) - stat.times.idle - stat.times.iowait
        total = sum(vals)
        with self._mu:
            prev = self._prev
            if prev is not None and total > prev[1]:
                self._prev = (busy, total)
                self._last_percent = 100.0 * (busy - prev[0]) / (total - prev[1])
                stat.percent = self._last_percent
            elif prev is not None:
                # Counter hasn't advanced — keep the last window's value.
                stat.percent = self._last_percent or 0.0
            else:
                self._prev = (busy, total)
                # First sample ever: since-boot average is all we have.
                stat.percent = 100.0 * busy / total if total else 0.0
                self._last_percent = stat.percent
        return stat


_default_cpu_sampler = CPUSampler()


def _read_cpu() -> CPUStat:
    return _default_cpu_sampler.read()


def local_ip() -> str:
    """Best-effort routable local IP (the address peers should dial)."""
    return _local_ip()


def _local_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))  # no packets sent; picks the default route
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


def collect(location: str = "", idc: str = "") -> HostInfo:
    """Snapshot this machine's stats the way the daemon announcer does."""
    uname = platform.uname()
    return HostInfo(
        ip=_local_ip(),
        hostname=socket.gethostname(),
        os=uname.system.lower(),
        platform=uname.system.lower(),
        platform_family=uname.system.lower(),
        platform_version=uname.release,
        kernel_version=uname.release,
        cpu=_read_cpu(),
        memory=_read_meminfo(),
        network=NetworkStat(location=location, idc=idc),
        disk=_read_disk(),
        build=BuildInfo(platform=uname.machine, go_version=platform.python_version()),
    )
