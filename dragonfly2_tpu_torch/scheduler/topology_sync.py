"""Cross-replica topology sharing + local durability.

Reference: the probe graph lives in Redis (scheduler/networktopology/
network_topology.go:55-88, pkg/redis) — shared across scheduler replicas
and surviving restarts.  The TPU build's Redis analog is the MANAGER:

- ``TopologySync`` pushes this scheduler's edge summaries to
  ``POST /api/v1/topology`` and pulls the other replicas' from
  ``GET /api/v1/topology?exclude=<self>``, merging newest-wins into the
  live store (NetworkTopology.merge_remote_edges) — a probe landed on
  scheduler A informs the nt evaluator's ranking on B within one sync
  interval;
- durability is a per-scheduler JSON state file
  (NetworkTopology.save/load) reloaded at boot, so a restart keeps its
  RTT knowledge even with no manager configured.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Optional

from .networktopology import NetworkTopology

logger = logging.getLogger(__name__)


class TopologySync:
    def __init__(
        self,
        topology: NetworkTopology,
        manager_url,
        scheduler_id: str,
        *,
        token: Optional[str] = None,
        interval_s: float = 30.0,
        timeout: float = 10.0,
        state_path: Optional[str] = None,
    ) -> None:
        from ..rpc.resolver import ManagerEndpoints

        self.topology = topology
        # Replica list / shared ManagerEndpoints: sync fails over with
        # every other manager client in the process.
        self.endpoints = ManagerEndpoints.of(manager_url, client="topology")
        self.scheduler_id = scheduler_id
        self.token = token
        self.interval_s = interval_s
        self.timeout = timeout
        # Persisted alongside each sync so a crash costs at most one
        # interval of probes.
        self.state_path = state_path
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _headers(self) -> dict:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    def sync_once(self) -> int:
        """Push local edges, pull + merge the other replicas'; returns the
        number of remote edges adopted.  Manager outages degrade to the
        local store (and the disk state keeps durability)."""
        from ..utils import faultinject

        adopted = 0

        def one_endpoint(base: str):
            faultinject.fire("scheduler.topology.sync")
            body = json.dumps({
                "scheduler_id": self.scheduler_id,
                "edges": self.topology.export_edges(),
            }).encode()
            req = urllib.request.Request(
                base + "/api/v1/topology", data=body,
                headers=self._headers(), method="POST",
            )
            urllib.request.urlopen(req, timeout=self.timeout).close()

            with urllib.request.urlopen(
                urllib.request.Request(
                    base + f"/api/v1/topology?exclude={self.scheduler_id}",
                    headers=self._headers(),
                ),
                timeout=self.timeout,
            ) as resp:
                return json.loads(resp.read()).get("edges", [])

        try:
            remote = self.endpoints.call(one_endpoint)
            adopted = self.topology.merge_remote_edges(remote)
        except Exception as exc:  # noqa: BLE001 — outage ≠ crash
            logger.debug("topology sync failed: %s", exc)
        if self.state_path:
            try:
                self.topology.save(self.state_path)
            except OSError as exc:
                logger.warning("topology state save failed: %s", exc)
        return adopted

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.sync_once()

        self._thread = threading.Thread(
            target=loop, name="topology-sync", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.state_path:
            try:
                self.topology.save(self.state_path)
            except OSError:
                pass
