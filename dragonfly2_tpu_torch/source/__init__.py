"""Back-to-source protocol clients (reference: pkg/source/).

A registry of scheme → client (the reference loads http, s3, oss, hdfs,
oci clients via pkg/source/loader); each client answers content length
and range reads, and ``PieceSourceFetcher`` adapts any client to the
conductor's piece interface.

Shipped clients: ``file`` (local paths; also the e2e fixture transport),
``http/https`` (urllib range GETs), ``s3`` (SigV4-signed, endpoint-
overridable), ``oss`` (header-signed), ``hdfs`` (WebHDFS REST), and
``oras``/``oci`` (harbor-style token → manifest → blob).  The cloud
schemes need credentials/endpoints, so they register through
``configure_sources`` at deploy time the way the reference's plugin
loader does.

Port of ``dragonfly2_tpu/source/``, verbatim.
"""

from typing import Optional

from .client import (  # noqa: F401
    FileSourceClient,
    HTTPSourceClient,
    PieceSourceFetcher,
    SourceClient,
    SourceRegistry,
    default_registry,
)
from .hdfs import HDFSSourceClient  # noqa: F401
from .oci import ORASSourceClient  # noqa: F401
from .oss import OSSSourceClient  # noqa: F401
from .s3 import S3SourceClient  # noqa: F401


def configure_sources(
    source_cfg: dict, registry: Optional[SourceRegistry] = None
) -> SourceRegistry:
    """Register cloud scheme clients from a config mapping.

    ``source_cfg`` is the daemon config's ``source:`` section, e.g.::

        source:
          s3:  {access_key: "...", secret_key: "...", region: "...",
                endpoint: "..."}
          oss: {access_key_id: "...", access_key_secret: "...",
                endpoint: "..."}
          hdfs: {user: "hadoop"}
          oras: {auth_header: "Basic ...", insecure_http: false}
    """
    reg = registry or default_registry
    if "s3" in source_cfg:
        reg.register("s3", S3SourceClient(**source_cfg["s3"]))
    if "oss" in source_cfg:
        reg.register("oss", OSSSourceClient(**source_cfg["oss"]))
    if "hdfs" in source_cfg:
        reg.register("hdfs", HDFSSourceClient(**source_cfg["hdfs"]))
    # oras and oci may target different registries with different creds:
    # each block configures its own scheme; a lone block serves both.
    oras_client = (
        ORASSourceClient(**source_cfg["oras"]) if "oras" in source_cfg else None
    )
    oci_client = (
        ORASSourceClient(**source_cfg["oci"]) if "oci" in source_cfg else None
    )
    if oras_client is not None:
        reg.register("oras", oras_client)
        reg.register("oci", oci_client or oras_client)
    elif oci_client is not None:
        reg.register("oci", oci_client)
        reg.register("oras", oci_client)
    return reg
