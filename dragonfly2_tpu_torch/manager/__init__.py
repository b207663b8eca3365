"""Manager control plane (reference: manager/), the part the
learned-scheduling loop depends on: the model registry — versioned
immutable scorer artifacts with transactional single-active activation
per scheduler (reference: manager/rpcserver/manager_server_v1.go:802-901
CreateModel, manager/service/model.go:103-190 activation) — the
durable-state seam its rows ride (``state.MemoryBackend``), scheduler
membership with keepalive (``cluster``), the scheduler-cluster searcher
(``searcher``), the CRUD rows whose cluster config feeds the schedulers'
dynconfig (``crud``), the dynconfig client (``dynconfig``), user
accounts with pbkdf2 passwords and personal access tokens (``users``),
the OAuth2 authorization-code sign-in seam (``oauth``) and the REST
surface over them (``rest.ManagerRESTServer``, imported from its module).
"""

from .searcher import ClusterScopes, SchedulerCluster, Searcher  # noqa: F401
from .dynconfig import Dynconfig, DynconfigServer  # noqa: F401
from .crud import CrudStore  # noqa: F401
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
from .users import PersonalAccessToken, User, UserStore  # noqa: F401
from .oauth import OAuthProvider, OAuthSignin  # noqa: F401
