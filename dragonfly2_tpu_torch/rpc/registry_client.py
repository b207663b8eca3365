"""RemoteRegistry: the manager model registry over its REST surface.

Reference counterparts: the trainer's managerclient.CreateModel
(pkg/rpc/manager/client/client_v1.go:101-122) and the scheduler's
model-version pull through dynconfig.  Implements the registry surface
that TrainerService (create_model) and ModelSubscriber
(active_model / load_artifact) consume, so both run unchanged against a
manager in another process.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from ..manager.registry import Model, ModelState
from .retry import retry_call


def _model_from_json(data: dict) -> Model:
    return Model(
        id=data["id"],
        name=data["name"],
        type=data["type"],
        version=data["version"],
        scheduler_id=data["scheduler_id"],
        state=ModelState(data["state"]),
        evaluation=data.get("evaluation") or {},
        artifact_digest=data.get("artifact_digest", ""),  # pre-digest managers
    )


class RemoteRegistry:
    """``base_url`` may be one URL, a comma-separated replica list, or a
    shared ``ManagerEndpoints`` — model polls and artifact fetches fail
    over to the surviving manager replica mid-flight (the HA story's
    zero-degraded-mode contract: a subscriber poll only pins when ALL
    replicas are down)."""

    def __init__(
        self, base_url, *, timeout: float = 30.0, token: Optional[str] = None
    ):
        from .resolver import ManagerEndpoints

        self.endpoints = ManagerEndpoints.of(base_url, client="registry")
        self.timeout = timeout
        # Bearer token for managers running RBAC (security/tokens.py); the
        # trainer's create_model needs PEER, activation needs OPERATOR.
        self.token = token

    @property
    def base_url(self) -> str:
        return self.endpoints.current()

    def _headers(self) -> dict:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    @staticmethod
    def _translate(exc: urllib.error.HTTPError):
        """HTTP status → the LOCAL registry's exception types, so callers
        written against ModelRegistry behave identically remotely."""
        try:
            message = json.loads(exc.read()).get("error", "")
        except (json.JSONDecodeError, ValueError):
            message = str(exc)
        if exc.code == 404:
            return KeyError(message or "not found")
        if exc.code == 400:
            return ValueError(message or "bad request")
        return RuntimeError(f"manager: HTTP {exc.code}: {message}")

    def _get(self, path: str, *, deadline_s: Optional[float] = None) -> Optional[dict]:
        def one_endpoint(base: str):
            from ..utils import faultinject

            faultinject.fire("rpc.registry.get")
            try:
                with urllib.request.urlopen(
                    base + path, timeout=self.timeout
                ) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                if exc.code == 404:
                    return None
                if exc.code == 503:
                    raise  # standby replica: endpoints.call fails over
                raise self._translate(exc) from exc

        def once():
            return self.endpoints.call(one_endpoint)

        # HTTPError is handled inside once(); connect-refused arrives as
        # URLError (an OSError, NOT ConnectionError) — include OSError so
        # transient manager restarts actually retry (scheduler_client's
        # pattern).  The endpoint sweep runs INSIDE each retry attempt:
        # backoff only engages once every replica has failed.
        return retry_call(
            once,
            retry_on=(ConnectionError, TimeoutError, OSError),
            deadline_s=deadline_s,
        )

    def _post(
        self, path: str, payload: dict, *, deadline_s: Optional[float] = None
    ) -> dict:
        def one_endpoint(base: str):
            from ..utils import faultinject

            faultinject.fire("rpc.registry.post")
            req = urllib.request.Request(
                base + path,
                data=json.dumps(payload).encode(),
                headers=self._headers(),
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                if exc.code == 503:
                    raise  # standby replica: endpoints.call fails over
                raise self._translate(exc) from exc

        def once():
            return self.endpoints.call(one_endpoint)

        return retry_call(
            once,
            retry_on=(ConnectionError, TimeoutError, OSError),
            deadline_s=deadline_s,
        )

    # -- the surfaces TrainerService / ModelSubscriber use -------------------

    def create_model(
        self,
        *,
        name: str,
        type: str,
        scheduler_id: str,
        artifact: bytes,
        evaluation: Optional[Dict[str, float]] = None,
        **_ignored,
    ) -> Model:
        data = self._post(
            "/api/v1/models",
            {
                "name": name,
                "type": type,
                "scheduler_id": scheduler_id,
                "artifact_b64": base64.b64encode(artifact).decode(),
                "evaluation": evaluation or {},
            },
        )
        return _model_from_json(data)

    def active_model(self, scheduler_id: str, name: str) -> Optional[Model]:
        data = self._get(
            "/api/v1/models:active?"
            + urllib.parse.urlencode({"scheduler_id": scheduler_id, "name": name})
        )
        return None if data is None else _model_from_json(data)

    def candidate_model(self, scheduler_id: str, name: str) -> Optional[Model]:
        data = self._get(
            "/api/v1/models:candidate?"
            + urllib.parse.urlencode({"scheduler_id": scheduler_id, "name": name})
        )
        return None if data is None else _model_from_json(data["model"])

    def load_artifact(self, model: Model) -> bytes:
        data = self._get(
            "/api/v1/models:artifact?" + urllib.parse.urlencode({"id": model.id})
        )
        if data is None:
            raise KeyError(f"artifact for {model.id} not found")
        blob = base64.b64decode(data["artifact_b64"])
        if model.artifact_digest:
            # Same end-to-end verification as the local registry — the
            # wire and the manager's blob store are both inside the
            # tamper/corruption perimeter this digest closes.
            import hashlib

            from ..manager.registry import ArtifactDigestError

            got = hashlib.sha256(blob).hexdigest()
            if got != model.artifact_digest:
                raise ArtifactDigestError(
                    f"{model.id}: artifact sha256 {got[:12]}… != recorded "
                    f"{model.artifact_digest[:12]}…"
                )
        return blob

    def list(
        self,
        *,
        scheduler_id: Optional[str] = None,
        name: Optional[str] = None,
        **_ignored,
    ) -> List[Model]:
        params = {}
        if scheduler_id:
            params["scheduler_id"] = scheduler_id
        if name:
            params["name"] = name
        data = self._get("/api/v1/models?" + urllib.parse.urlencode(params))
        return [_model_from_json(d) for d in (data or [])]

    def activate(self, model_id: str) -> Model:
        return _model_from_json(
            self._post(f"/api/v1/models/{model_id}:activate", {})
        )

    def deactivate(self, model_id: str) -> Model:
        return _model_from_json(
            self._post(f"/api/v1/models/{model_id}:deactivate", {})
        )

    def get(self, model_id: str) -> Optional[Model]:
        data = self._get(
            "/api/v1/models:get?" + urllib.parse.urlencode({"id": model_id})
        )
        return None if data is None else _model_from_json(data)
