"""Manager control plane (reference: manager/), the part the
learned-scheduling loop depends on: the model registry — versioned
immutable scorer artifacts with transactional single-active activation
per scheduler (reference: manager/rpcserver/manager_server_v1.go:802-901
CreateModel, manager/service/model.go:103-190 activation) — the
durable-state seam its rows ride (``state.MemoryBackend``), scheduler
membership with keepalive (``cluster``) and the REST surface over both
(``rest.ManagerRESTServer``, imported from its module).
"""

from .cluster import ClusterManager, SchedulerInstance, SeedPeerInstance  # noqa: F401
from .registry import (  # noqa: F401
    ArtifactDigestError,
    BlobStore,
    KVBlobStore,
    Model,
    ModelRegistry,
    ModelState,
)
from .state import KVTable, MemoryBackend, StateBackend  # noqa: F401
