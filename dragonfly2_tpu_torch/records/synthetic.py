"""Synthetic cluster with ground-truth bandwidth: the host latents.

A latent cluster model whose per-edge bandwidth is a deterministic
function of latent host capacities, load and topology plus noise.  This
package keeps the host latents (the announce swarm and the serving
smoke run build their hosts from them) and the bandwidth ground truth; the
record-level and vectorized training-row generators wait for the trainer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils import idgen

IDC_NAMES = ("idc-a", "idc-b", "idc-c", "idc-d")
REGIONS = ("region-1", "region-2")
PIECE_SIZE = 4 << 20  # 4 MiB default piece size (reference daemon default)


@dataclass
class LatentHost:
    index: int
    id: str
    hostname: str
    ip: str
    type: str            # normal | super | strong | weak
    idc: int
    region: int
    zone: int
    up_capacity: float   # bytes/sec
    down_capacity: float
    cpu_load: float      # [0,1]
    mem_load: float
    disk_load: float
    tcp_conns: int
    upload_conns: int
    concurrent_uploads: int
    upload_limit: int
    upload_count: int
    upload_failed: int

    @property
    def location(self) -> str:
        return f"{REGIONS[self.region]}|zone-{self.zone}|rack-{self.index % 8}"

    @property
    def idc_name(self) -> str:
        return IDC_NAMES[self.idc]


class SyntheticCluster:
    """A latent cluster whose edge bandwidth is ground truth.

    bandwidth(parent→child) =
        min(parent_up / (1 + a·uploads), child_down)
        · idc/region affinity factor · cpu-load factor · lognormal noise
    """

    def __init__(self, num_hosts: int = 64, seed: int = 0, seed_peer_fraction: float = 0.06):
        self.rng = np.random.default_rng(seed)
        self.num_hosts = num_hosts
        r = self.rng
        n = num_hosts
        self.idc = r.integers(0, len(IDC_NAMES), n)
        self.region = r.integers(0, len(REGIONS), n)
        self.zone = r.integers(0, 4, n)
        # capacities: lognormal around 60 MB/s up, 120 MB/s down; seeds beefier
        self.up_cap = np.exp(r.normal(math.log(60e6), 0.7, n))
        self.down_cap = np.exp(r.normal(math.log(120e6), 0.5, n))
        is_seed = r.random(n) < seed_peer_fraction
        self.host_type = np.where(is_seed, 1, 0)  # 1 => super seed
        self.up_cap[is_seed] *= 4.0
        self.cpu_load = np.clip(r.beta(2, 5, n), 0, 1)
        self.mem_load = np.clip(r.beta(2, 4, n), 0, 1)
        self.disk_load = np.clip(r.beta(2, 6, n), 0, 1)
        self.tcp_conns = r.integers(4, 400, n)
        self.upload_conns = r.integers(0, 60, n)
        self.upload_limit = np.full(n, 50)
        self.concurrent_uploads = r.integers(0, 30, n)
        self.upload_count = r.integers(10, 5000, n)
        self.upload_failed = (self.upload_count * np.clip(r.beta(1, 12, n), 0, 1)).astype(np.int64)
        self.hosts: List[LatentHost] = [self._make_host(i) for i in range(n)]

    def _make_host(self, i: int) -> LatentHost:
        ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        hostname = f"host-{i}"
        htype = "super" if self.host_type[i] == 1 else "normal"
        # Identity never changes across drift() rebuilds — cache the hash
        # (drift replay at soak scale would otherwise re-hash 100k ids
        # per epoch).
        if not hasattr(self, "_host_id_cache"):
            self._host_id_cache = {}
        hid = self._host_id_cache.get(i)
        if hid is None:
            hid = idgen.host_id_v2(ip, hostname, seed_peer=htype != "normal")
            self._host_id_cache[i] = hid
        return LatentHost(
            index=i,
            id=hid,
            hostname=hostname,
            ip=ip,
            type=htype,
            idc=int(self.idc[i]),
            region=int(self.region[i]),
            zone=int(self.zone[i]),
            up_capacity=float(self.up_cap[i]),
            down_capacity=float(self.down_cap[i]),
            cpu_load=float(self.cpu_load[i]),
            mem_load=float(self.mem_load[i]),
            disk_load=float(self.disk_load[i]),
            tcp_conns=int(self.tcp_conns[i]),
            upload_conns=int(self.upload_conns[i]),
            concurrent_uploads=int(self.concurrent_uploads[i]),
            upload_limit=int(self.upload_limit[i]),
            upload_count=int(self.upload_count[i]),
            upload_failed=int(self.upload_failed[i]),
        )

    # -- ground truth --------------------------------------------------------

    def bandwidth(self, parent: int, child: int, noise: bool = True) -> float:
        return float(self._bandwidth_vec(np.array([parent]), np.array([child]), noise)[0])

    def _bandwidth_vec(
        self,
        parent: np.ndarray,
        child: np.ndarray,
        noise: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """``rng`` overrides the cluster's SHARED generator for the
        measurement noise — position-deterministic streams (the 1B soak's
        resumable ingest) must not depend on how many draws happened
        before; the noise model itself (σ=0.12 lognormal, 1 KB/s floor
        AFTER noise) lives only here."""
        up = self.up_cap[parent] / (1.0 + 0.15 * self.concurrent_uploads[parent])
        eff = np.minimum(up, self.down_cap[child])
        same_idc = self.idc[parent] == self.idc[child]
        same_region = self.region[parent] == self.region[child]
        factor = np.where(same_idc, 1.0, np.where(same_region, 0.55, 0.25))
        cpu_factor = 1.0 - 0.5 * self.cpu_load[parent] ** 2
        bw = eff * factor * cpu_factor
        if noise:
            bw = bw * np.exp((rng or self.rng).normal(0.0, 0.12, bw.shape))
        return np.maximum(bw, 1e3)
