"""Versioned model registry with single-active activation.

Reference semantics (manager/):
- models are immutable versioned objects keyed (scheduler_id, name, type,
  version); CreateModel writes the artifact to object storage and records
  a DB row with evaluation metrics, state=inactive
  (manager_server_v1.go:802-901, models/model.go:35-46);
- activation is transactional and single-active per scheduler: activating
  version V first deactivates the currently-active version, then flips V
  (service/model.go:103-190 — the config.pbtxt version-policy rewrite
  becomes a pointer update here);
- model types: ``gnn`` | ``mlp`` (models/model.go).

The artifact bytes here are trainer/export.py scorer blobs (npz), stored
in a content-addressed blob store (filesystem dir, in-memory, or rows of
the manager's StateBackend), replacing the reference's S3/OSS Triton
layout (types/model.go:66-73).

Port of ``dragonfly2_tpu/manager/registry.py``.
"""

from __future__ import annotations

import enum
import os
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:  # state seam type (no runtime import needed)
    from .state import StateBackend

class ModelState(str, enum.Enum):
    """Version lifecycle.  The reference knows only active/inactive
    (models/model.go); SHADOW and CANARY are the rollout plane's
    intermediate gates (rollout/controller.py): a SHADOW version is
    re-scored against the active one off the hot path, a CANARY version
    serves a deterministic hash-bucketed slice of announces.  At most
    one version per (scheduler_id, name) holds each of ACTIVE / SHADOW /
    CANARY."""

    ACTIVE = "active"
    INACTIVE = "inactive"
    SHADOW = "shadow"
    CANARY = "canary"


# States a rollout candidate occupies while under evaluation.
CANDIDATE_STATES = (ModelState.SHADOW, ModelState.CANARY)


class ArtifactDigestError(ValueError):
    """Stored blob bytes do not hash to the digest recorded at
    create_model — the artifact was corrupted or swapped in place."""


@dataclass
class Model:
    """One model version (manager/models/model.go:35-46)."""

    id: str
    name: str
    type: str                      # "gnn" | "mlp"
    version: int
    scheduler_id: str
    state: ModelState = ModelState.INACTIVE
    evaluation: Dict[str, float] = field(default_factory=dict)
    blob_key: str = ""
    # sha256 hex of the artifact bytes, recorded at create_model and
    # verified on every load_artifact (rows predating the field carry "").
    artifact_digest: str = ""
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)


class BlobStore:
    """Content-addressed artifact store (objectstorage replacement).

    ``directory=None`` keeps blobs in memory (tests / embedded runs).
    """

    def __init__(self, directory: Optional[str] = None) -> None:
        self._dir = directory
        self._mem: Dict[str, bytes] = {}
        if directory:
            os.makedirs(directory, exist_ok=True)

    def put(self, key: str, data: bytes) -> None:
        if self._dir:
            path = os.path.join(self._dir, key)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic: readers never see partial blobs
        else:
            self._mem[key] = data

    def get(self, key: str) -> bytes:
        if self._dir:
            with open(os.path.join(self._dir, key), "rb") as f:
                return f.read()
        return self._mem[key]

    def exists(self, key: str) -> bool:
        if self._dir:
            return os.path.exists(os.path.join(self._dir, key))
        return key in self._mem


class KVBlobStore:
    """Artifact store riding the manager's StateBackend (one row per
    blob, base64 docs).  The HA composition uses this instead of a blob
    directory so artifacts flow through the SAME replication log as
    their registry rows — a promoted standby can serve
    ``models:artifact`` without a shared filesystem (the reference
    stores artifacts in S3/OSS, which is externally HA the same way).

    Single-writer discipline: ``put`` is only reached from
    ``ModelRegistry.create_model`` under ``ModelRegistry._mu`` (the
    registry row and its blob row are one logical write); no lock of
    its own, so the lock hierarchy stays flat."""

    def __init__(self, backend) -> None:
        import base64 as _b64

        self._b64 = _b64
        self._table = backend.table("blobs")
        # Blobs are fetched by key on demand; the boot-time load only
        # proves the table reads back.
        self._known = set(self._table.load_all())

    def put(self, key: str, data: bytes) -> None:
        self._table.put(key, {"b64": self._b64.b64encode(data).decode()})
        self._known.add(key)

    def get(self, key: str) -> bytes:
        doc = self._table.get(key)
        if doc is None:
            raise KeyError(key)
        return self._b64.b64decode(doc["b64"])

    def exists(self, key: str) -> bool:
        return self._table.get(key) is not None


def _model_to_doc(m: Model) -> dict:
    return {
        "id": m.id, "name": m.name, "type": m.type, "version": m.version,
        "scheduler_id": m.scheduler_id, "state": m.state.value,
        "evaluation": m.evaluation, "blob_key": m.blob_key,
        "artifact_digest": m.artifact_digest,
        "created_at": m.created_at, "updated_at": m.updated_at,
    }


def _model_from_doc(d: dict) -> Model:
    return Model(
        id=d["id"], name=d["name"], type=d["type"], version=d["version"],
        scheduler_id=d["scheduler_id"], state=ModelState(d["state"]),
        evaluation=dict(d["evaluation"]), blob_key=d["blob_key"],
        artifact_digest=d.get("artifact_digest", ""),  # pre-digest rows
        created_at=d["created_at"], updated_at=d["updated_at"],
    )


class ModelRegistry:
    """The registry service (manager CreateModel + model REST CRUD).

    Durable rows live behind the manager's state seam
    (manager/state.StateBackend): every mutation writes through and a
    restart reloads the table — models survive the manager the way the
    reference's DB rows do.  ``db_path`` is the convenience form (a
    private SQLiteBackend).
    """

    def __init__(
        self,
        blob_store=None,
        *,
        db_path: Optional[str] = None,
        backend: "Optional[StateBackend]" = None,
    ) -> None:
        if backend is None and db_path:
            from .state import SQLiteBackend

            backend = SQLiteBackend(db_path)
        self._mu = threading.RLock()
        self._models: Dict[str, Model] = {}
        self.blobs = blob_store or BlobStore()
        self._table = None
        if backend is not None:
            self._table = backend.table("models")
            self._models = {
                k: _model_from_doc(d) for k, d in self._table.load_all().items()
            }

    def _persist(self, *models: Model) -> None:
        if self._table is not None:
            # ONE transaction: activation flips two rows and a crash
            # between separate commits would leave two ACTIVE versions.
            self._table.put_many({m.id: _model_to_doc(m) for m in models})

    # -- CreateModel (manager_server_v1.go:802-901) -------------------------

    def create_model(
        self,
        *,
        name: str,
        type: str,
        scheduler_id: str,
        artifact: bytes,
        evaluation: Optional[Dict[str, float]] = None,
        ip: str = "",
        hostname: str = "",
    ) -> Model:
        # mlp_int8 / mlp_bf16: post-training-quantized serving variants
        # (trainer/export.quantize_scorer) — registered as CANDIDATEs and
        # admitted to ACTIVE only through the rollout plane's replay
        # gates.
        if type not in ("gnn", "mlp", "mlp_int8", "mlp_bf16"):
            raise ValueError(f"unknown model type {type!r}")
        with self._mu:
            version = (
                max(
                    (
                        m.version
                        for m in self._models.values()
                        if m.scheduler_id == scheduler_id and m.name == name
                    ),
                    default=0,
                )
                + 1
            )
            # Model identity is keyed by (scheduler_id, name): hashing only
            # ip/hostname would let two schedulers on one machine overwrite
            # each other's registry rows.  Full-id hash (no prefix
            # truncation) for the blob key too.
            from ..utils.digest import sha256_from_strings

            model_id = sha256_from_strings(scheduler_id, name)[:32]
            sched_key = sha256_from_strings(scheduler_id)[:24]
            blob_key = f"{name}-{sched_key}-v{version}.npz"
            self.blobs.put(blob_key, artifact)
            import hashlib

            model = Model(
                id=f"{model_id}-v{version}",
                name=name,
                type=type,
                version=version,
                scheduler_id=scheduler_id,
                evaluation=dict(evaluation or {}),
                blob_key=blob_key,
                # Content address for REAL: the row pins the bytes it was
                # created with, and load_artifact refuses anything else.
                artifact_digest=hashlib.sha256(artifact).hexdigest(),
            )
            self._models[model.id] = model
            self._persist(model)
            return model

    # -- activation (service/model.go:103-190) ------------------------------

    def activate(self, model_id: str) -> Model:
        """Single-active per (scheduler, name): flips the previous active
        version to inactive and the named version to active, atomically."""
        with self._mu:
            model = self._models.get(model_id)
            if model is None:
                raise KeyError(model_id)
            changed = [model]
            for other in self._models.values():
                if (
                    other.scheduler_id == model.scheduler_id
                    and other.name == model.name
                    and other.state is ModelState.ACTIVE
                ):
                    other.state = ModelState.INACTIVE
                    other.updated_at = time.time()
                    changed.append(other)
            model.state = ModelState.ACTIVE
            model.updated_at = time.time()
            self._persist(*changed)
            return model

    def deactivate(self, model_id: str) -> Model:
        with self._mu:
            model = self._models[model_id]
            model.state = ModelState.INACTIVE
            model.updated_at = time.time()
            self._persist(model)
            return model

    def set_state(self, model_id: str, state: ModelState) -> Model:
        """Rollout-plane transitions (SHADOW/CANARY/INACTIVE).  Like
        ``activate``, the flip is exclusive per (scheduler_id, name) for
        SHADOW and CANARY — one candidate at a time — and all touched
        rows persist in ONE transaction.  ACTIVE must go through
        ``activate`` (it owns the single-active flip)."""
        if state is ModelState.ACTIVE:
            return self.activate(model_id)
        with self._mu:
            model = self._models.get(model_id)
            if model is None:
                raise KeyError(model_id)
            changed = [model]
            if state in CANDIDATE_STATES:
                for other in self._models.values():
                    if (
                        other is not model
                        and other.scheduler_id == model.scheduler_id
                        and other.name == model.name
                        and other.state in CANDIDATE_STATES
                    ):
                        other.state = ModelState.INACTIVE
                        other.updated_at = time.time()
                        changed.append(other)
            model.state = state
            model.updated_at = time.time()
            self._persist(*changed)
            return model

    def delete(self, model_id: str) -> None:
        with self._mu:
            self._models.pop(model_id, None)
            if self._table is not None:
                self._table.delete(model_id)

    # -- reads ---------------------------------------------------------------

    def get(self, model_id: str) -> Optional[Model]:
        with self._mu:
            return self._models.get(model_id)

    def list(
        self,
        *,
        scheduler_id: Optional[str] = None,
        name: Optional[str] = None,
        type: Optional[str] = None,
        state: Optional[ModelState] = None,
    ) -> List[Model]:
        with self._mu:
            out = []
            for m in self._models.values():
                if scheduler_id is not None and m.scheduler_id != scheduler_id:
                    continue
                if name is not None and m.name != name:
                    continue
                if type is not None and m.type != type:
                    continue
                if state is not None and m.state is not state:
                    continue
                out.append(m)
            return sorted(out, key=lambda m: (m.name, m.version))

    def active_model(self, scheduler_id: str, name: str) -> Optional[Model]:
        """What the scheduler's dynconfig poll asks: the active version."""
        with self._mu:
            for m in self._models.values():
                if (
                    m.scheduler_id == scheduler_id
                    and m.name == name
                    and m.state is ModelState.ACTIVE
                ):
                    return m
            return None

    def candidate_model(self, scheduler_id: str, name: str) -> Optional[Model]:
        """The version under rollout evaluation (SHADOW or CANARY), if
        any — what the scheduler's candidate poll asks."""
        with self._mu:
            for m in self._models.values():
                if (
                    m.scheduler_id == scheduler_id
                    and m.name == name
                    and m.state in CANDIDATE_STATES
                ):
                    return m
            return None

    def load_artifact(self, model: Model) -> bytes:
        data = self.blobs.get(model.blob_key)
        if model.artifact_digest:
            import hashlib

            got = hashlib.sha256(data).hexdigest()
            if got != model.artifact_digest:
                raise ArtifactDigestError(
                    f"{model.id}: artifact sha256 {got[:12]}… != recorded "
                    f"{model.artifact_digest[:12]}… — blob corrupted or swapped"
                )
        return data
