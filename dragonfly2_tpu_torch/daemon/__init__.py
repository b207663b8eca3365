"""Peer daemon data plane (reference: client/daemon/).

The download engine that turns scheduler decisions into bytes on disk:

- ``storage``        — local piece store (the native engine when it
                       builds, else the Python one) + disk-quota
                       reclaimer (client/daemon/storage/storage_manager.go).
- ``upload``         — serves pieces to other peers
                       (client/daemon/upload/upload_manager.go); in-process
                       transport here, the HTTP/range layer binds onto it.
- ``conductor``      — per-task download orchestration: register →
                       parents → piece workers → back-to-source fallback
                       (client/daemon/peer/peertask_conductor.go).
- ``traffic_shaper`` — per-task bandwidth allocation
                       (client/daemon/peer/traffic_shaper.go).
- ``pex``            — peer exchange pool: membership + per-peer piece
                       advertisement (client/daemon/pex/).
- ``daemon``         — composition root (client/daemon/daemon.go).
- ``host_announcer`` — the daemon's periodic ``announce_host``.
- ``piece_pipeline`` — the commit pipeline, report batcher, hedging and
                       the commit tee the conductor drives.

- ``pex_net``        — the gossip bus over UDP (memberlist analog).
- ``proxy``, ``relay`` — the forward proxy that diverts matched GETs
                       (image layers) into P2P, and its tunnel relay.
- ``gateway``        — the object gateway over ``objectstorage``.
- ``seeder``         — the seed peer's ``ObtainSeeds`` face.
- ``sni``            — the SNI-hijack proxy on the HTTPS port.

Port of ``dragonfly2_tpu/daemon/``.
"""

from .storage import DaemonStorage  # noqa: F401
from .upload import UploadManager  # noqa: F401
from .conductor import Conductor, DownloadResult, PieceFetcher  # noqa: F401
from .traffic_shaper import TrafficShaper  # noqa: F401
from .pex import PeerExchange  # noqa: F401
from .daemon import Daemon  # noqa: F401
