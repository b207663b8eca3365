"""Training-record layer: schemas, featurization, synthetic host latents."""

from .schema import (  # noqa: F401
    Download,
    DownloadError,
    HostRecord,
    NetworkTopologyRecord,
    Parent,
    Piece,
    ProbeStats,
    TaskRecord,
)
