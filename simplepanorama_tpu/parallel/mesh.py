"""Device mesh + sharding helpers.

The reference's parallelism is a single-process thread pool
(std::async over images, std::thread over (i,j) pairs, OpenMP over match
chunks — SURVEY §2.7). The device equivalents are mesh axes:

  * ``images``/``pairs``: data-parallel batch axes for SIFT extraction and
    pair verification (independent work, no collectives);
  * ``match``: the BA normal-equation axis — per-match Jacobian blocks are
    computed locally and segment-summed; XLA turns the cross-shard
    reduction into a psum over the mesh axis.

All helpers work on any backend (the CI fake backend is an 8-device CPU
mesh via --xla_force_host_platform_device_count).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


# Pipeline-wide switch: when False, run_pipeline and its stages stay
# single-device even if more devices are attached (used by parity tests to
# produce the reference single-device result in the same process).
PIPELINE_SHARDING = True


def pipeline_mesh(axis: str = "data") -> Optional[Mesh]:
    """The mesh the pipeline stages shard over, or None when running
    single-device (one device attached, or sharding disabled).

    Uses the LOCAL devices: in multi-process mode each host runs the
    single-controller pipeline over its own devices and the image list is
    split at the host level (multihost.host_shard) — device_put with a
    non-addressable global sharding is not possible for host-local data.
    """
    if not PIPELINE_SHARDING:
        return None
    devs = jax.local_devices()
    import os
    limit = os.environ.get("SPT_MESH_LIMIT")
    if limit:
        devs = devs[:max(1, int(limit))]  # bench --mesh N on real chips
    if len(devs) <= 1:
        return None
    return Mesh(np.array(devs), (axis,))


def pad_leading(n: int, d: int) -> int:
    """Smallest multiple of d that is >= n."""
    return (n + d - 1) // d * d


def shard_leading(tree, mesh: Mesh, axis: str = "data"):
    """device_put every array with its LEADING axis sharded over ``axis``
    (leading dims must be divisible by the mesh size)."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def shard_matches(data, mesh: Mesh, axis: str = "data"):
    """Place BAData with the match axis sharded across ``axis`` (camera
    tables are tiny and live replicated)."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda x: jax.device_put(x, sh), data)


def replicated(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))
