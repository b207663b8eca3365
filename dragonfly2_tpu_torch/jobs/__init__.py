"""Async job system (reference: internal/job + manager/job + scheduler/job).

The reference runs machinery (Redis-brokered task queue) with group jobs:
the manager fans a preheat out to scheduler clusters and aggregates group
state (preheat.go:126-167, internal/job/job.go:48-147).  Here the broker
is an in-process queue bus with the same model — named queues, workers,
group jobs with aggregated state — and the preheat job drives seed-peer
downloads through the real scheduler/daemon stack.

Port of ``dragonfly2_tpu/jobs/__init__.py``, verbatim but for the imports.
"""

from .queue import GroupJob, JobQueue, JobState, Worker  # noqa: F401
from .preheat import PreheatJob, preheat, preheat_image  # noqa: F401
from .image import ImageResolver, parse_manifest_url  # noqa: F401
from .sync_peers import SyncPeers, make_sync_peers_handler  # noqa: F401
