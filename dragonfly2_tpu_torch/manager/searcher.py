"""Scheduler-cluster searcher (reference: manager/searcher/searcher.go).

A joining daemon reports (ip, hostname, idc, location); the searcher ranks
scheduler clusters by weighted affinity and returns them best-first.

Weights (searcher.go:49-62): CIDR 0.3, hostname-regex 0.3, IDC 0.25,
location 0.14, cluster-type (default flag) 0.01.  Location affinity
matches '|'-separated prefix segments capped at 5 (like the evaluator's).
Clusters with no live schedulers are filtered out (searcher.go:146-152).

Port of ``dragonfly2_tpu/manager/searcher.py``, verbatim but for the imports.
"""

from __future__ import annotations

import ipaddress
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

CIDR_WEIGHT = 0.3
HOSTNAME_WEIGHT = 0.3
IDC_WEIGHT = 0.25
LOCATION_WEIGHT = 0.14
CLUSTER_TYPE_WEIGHT = 0.01

MAX_LOCATION_ELEMENTS = 5


@dataclass
class ClusterScopes:
    """Affinity scopes configured per cluster (searcher.go Scopes)."""

    idc: str = ""                      # '|' separated accepted IDCs
    location: str = ""                 # '|' separated path
    cidrs: Sequence[str] = field(default_factory=tuple)
    hostnames: Sequence[str] = field(default_factory=tuple)  # regexes


@dataclass
class SchedulerCluster:
    id: str
    name: str = ""
    scopes: ClusterScopes = field(default_factory=ClusterScopes)
    is_default: bool = False
    scheduler_ids: List[str] = field(default_factory=list)  # live schedulers


def _cidr_score(ip: str, cidrs: Sequence[str]) -> float:
    if not ip or not cidrs:
        return 0.0
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return 0.0
    for cidr in cidrs:
        try:
            if addr in ipaddress.ip_network(cidr, strict=False):
                return 1.0
        except ValueError:
            continue
    return 0.0


def _hostname_score(hostname: str, patterns: Sequence[str]) -> float:
    if not hostname or not patterns:
        return 0.0
    for pat in patterns:
        try:
            if re.search(pat, hostname):
                return 1.0
        except re.error:
            continue
    return 0.0


def _idc_score(idc: str, scope_idc: str) -> float:
    if not idc or not scope_idc:
        return 0.0
    accepted = {s.strip().lower() for s in scope_idc.split("|")}
    return 1.0 if idc.lower() in accepted else 0.0


def _location_score(location: str, scope_location: str) -> float:
    if not location or not scope_location:
        return 0.0
    if location.lower() == scope_location.lower():
        return 1.0
    a, b = location.split("|"), scope_location.split("|")
    n = min(len(a), len(b), MAX_LOCATION_ELEMENTS)
    score = 0
    for i in range(n):
        if a[i].lower() != b[i].lower():
            break
        score += 1
    return score / MAX_LOCATION_ELEMENTS


class Searcher:
    """FindSchedulerClusters (searcher.go:106-139)."""

    def evaluate(
        self,
        cluster: SchedulerCluster,
        *,
        ip: str = "",
        hostname: str = "",
        idc: str = "",
        location: str = "",
    ) -> float:
        s = cluster.scopes
        return (
            CIDR_WEIGHT * _cidr_score(ip, s.cidrs)
            + HOSTNAME_WEIGHT * _hostname_score(hostname, s.hostnames)
            + IDC_WEIGHT * _idc_score(idc, s.idc)
            + LOCATION_WEIGHT * _location_score(location, s.location)
            + CLUSTER_TYPE_WEIGHT * (1.0 if cluster.is_default else 0.0)
        )

    def find_scheduler_clusters(
        self,
        clusters: Sequence[SchedulerCluster],
        *,
        ip: str = "",
        hostname: str = "",
        conditions: Optional[Dict[str, str]] = None,
    ) -> List[SchedulerCluster]:
        conditions = conditions or {}
        live = [c for c in clusters if c.scheduler_ids]
        if not live:
            raise LookupError("no scheduler clusters with live schedulers")
        return sorted(
            live,
            key=lambda c: self.evaluate(
                c,
                ip=ip,
                hostname=hostname,
                idc=conditions.get("idc", ""),
                location=conditions.get("location", ""),
            ),
            reverse=True,
        )
