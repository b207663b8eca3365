"""Rollout-plane clients: how a scheduler talks to the rollout
controller.

Port of ``dragonfly2_tpu/rollout/client.py``.  Two implementations of
one small surface:

- ``candidate(scheduler_id, name)`` — the version under evaluation (a
  ``CandidateInfo`` with the model row, rollout phase and canary
  percent), or None;
- ``report(scheduler_id, name, payload)`` — post one evaluation report
  (rollout/evaluation.py ``evaluate_shadow`` output) and get the
  controller's decision back;
- ``begin(model_id)`` — start the evidence-gated rollout for a freshly
  registered version (CANDIDATE → SHADOW), the lifecycle daemon's
  zero-human entry into the promotion plane (lifecycle/daemon.py).

``LocalRolloutClient`` wraps an in-process ``RolloutController`` (tests,
embedded runs).  ``RolloutRESTClient`` rides the manager's REST surface
(manager/rest.py rollout routes) with the same retry/translate
discipline as rpc/registry_client.py, and fires the ``rollout.fetch`` /
``rollout.report`` / ``rollout.begin`` fault seams
(utils/faultinject.py).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Optional

from ..manager.registry import Model
from ..rpc.retry import retry_call


@dataclass
class CandidateInfo:
    model: Model
    phase: str                # "shadow" | "canary"
    canary_percent: int


class LocalRolloutClient:
    """In-process controller + registry (same process as the manager)."""

    def __init__(self, controller) -> None:
        self.controller = controller
        self.registry = controller.registry

    def candidate(self, scheduler_id: str, name: str) -> Optional[CandidateInfo]:
        model = self.registry.candidate_model(scheduler_id, name)
        if model is None:
            return None
        rollout = self.controller.get(scheduler_id, name)
        return CandidateInfo(
            model=model,
            phase=model.state.value,
            canary_percent=rollout.canary_percent if rollout else 0,
        )

    def report(self, scheduler_id: str, name: str, payload: dict) -> dict:
        return self.controller.report(scheduler_id, name, payload)

    def begin(self, model_id: str, *, canary_percent: Optional[int] = None) -> dict:
        return self.controller.to_json(
            self.controller.begin(model_id, canary_percent=canary_percent)
        )

    def load_artifact(self, model: Model) -> bytes:
        return self.registry.load_artifact(model)


class RolloutRESTClient:
    """The wire form (manager/rest.py rollout routes).  ``base_url``
    accepts a replica list / shared ``ManagerEndpoints`` like
    ``RemoteRegistry`` — candidate polls and evaluation reports fail
    over to the surviving manager replica."""

    def __init__(
        self, base_url, *, timeout: float = 15.0, token: Optional[str] = None
    ) -> None:
        from ..rpc.resolver import ManagerEndpoints

        self.endpoints = ManagerEndpoints.of(base_url, client="rollout")
        self.timeout = timeout
        self.token = token

    @property
    def base_url(self) -> str:
        return self.endpoints.current()

    def _headers(self) -> dict:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    def candidate(self, scheduler_id: str, name: str) -> Optional[CandidateInfo]:
        from ..rpc.registry_client import _model_from_json
        from ..utils import faultinject

        def one_endpoint(base: str):
            faultinject.fire("rollout.fetch")
            url = (
                base
                + "/api/v1/models:candidate?"
                + urllib.parse.urlencode(
                    {"scheduler_id": scheduler_id, "name": name}
                )
            )
            try:
                with urllib.request.urlopen(url, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                if exc.code == 404:
                    return None
                if exc.code == 503:
                    raise  # standby replica: endpoints.call fails over
                raise RuntimeError(f"manager: HTTP {exc.code}") from exc

        def once():
            return self.endpoints.call(one_endpoint)

        data = retry_call(
            once, retry_on=(ConnectionError, TimeoutError, OSError)
        )
        if data is None:
            return None
        return CandidateInfo(
            model=_model_from_json(data["model"]),
            phase=data["phase"],
            canary_percent=int(data.get("canary_percent", 0)),
        )

    def report(self, scheduler_id: str, name: str, payload: dict) -> dict:
        from ..utils import faultinject

        def one_endpoint(base: str):
            faultinject.fire("rollout.report")
            req = urllib.request.Request(
                base + "/api/v1/rollouts:report",
                data=json.dumps(
                    {
                        "scheduler_id": scheduler_id,
                        "name": name,
                        "report": payload,
                    }
                ).encode(),
                headers=self._headers(),
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                if exc.code == 404:
                    raise KeyError(f"no rollout for {scheduler_id}:{name}") from exc
                if exc.code == 503:
                    raise  # standby replica: endpoints.call fails over
                raise RuntimeError(f"manager: HTTP {exc.code}") from exc

        def once():
            return self.endpoints.call(one_endpoint)

        return retry_call(
            once, retry_on=(ConnectionError, TimeoutError, OSError)
        )

    def begin(self, model_id: str, *, canary_percent: Optional[int] = None) -> dict:
        from ..utils import faultinject

        def one_endpoint(base: str):
            faultinject.fire("rollout.begin")
            body: dict = {}
            if canary_percent is not None:
                body["canary_percent"] = int(canary_percent)
            req = urllib.request.Request(
                base + f"/api/v1/models/{model_id}:rollout",
                data=json.dumps(body).encode(),
                headers=self._headers(),
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                if exc.code == 404:
                    raise KeyError(model_id) from exc
                if exc.code == 400:
                    raise ValueError(f"rollout begin refused: {model_id}") from exc
                if exc.code == 503:
                    raise  # standby replica: endpoints.call fails over
                raise RuntimeError(f"manager: HTTP {exc.code}") from exc

        def once():
            return self.endpoints.call(one_endpoint)

        return retry_call(
            once, retry_on=(ConnectionError, TimeoutError, OSError)
        )
