"""Device-mesh construction and chain-axis sharding helpers."""

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


CHAIN_AXIS = "chains"


def make_mesh(
    num_devices: Optional[int] = None,
    axis_name: str = CHAIN_AXIS,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a 1-D mesh over the chain axis.

    Chains are embarrassingly parallel, so a flat mesh over all devices is
    the right layout; the pooled-adaptation all-reduces are the only
    cross-device traffic.
    """
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis_name,))


SLICE_AXIS = "slice"


def make_multislice_mesh(
    num_slices: int,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_names: Sequence[str] = (SLICE_AXIS, CHAIN_AXIS),
) -> Mesh:
    """2-D ``(hosts, cards)`` device grid, ``num_slices`` rows.

    The outer axis groups the devices of one host, the inner axis the
    cards within it; pass the device list ordered host-major.  Chains
    shard over BOTH axes (see :func:`chain_sharding`), so the pooled
    reductions become two-level collectives — within a host, then across
    hosts.  It is a plain grid, not a torus: every card of a host reaches
    every other at the same rate.
    """
    if devices is None:
        devices = jax.devices()
    if len(devices) % num_slices:
        raise ValueError(
            f"{len(devices)} devices do not split into {num_slices} slices"
        )
    grid = np.asarray(devices).reshape(num_slices, -1)
    return Mesh(grid, tuple(axis_names))


def chain_sharding(mesh: Mesh, axis_name: str = None) -> NamedSharding:
    """Sharding that splits the leading (chain) axis across the mesh.

    For a multi-axis mesh the chain axis shards over ALL mesh axes (so a
    ``(slice, chains)`` mesh splits the chain batch across every chip);
    pass ``axis_name`` to restrict to one axis.
    """
    if axis_name is None:
        spec = PartitionSpec(tuple(mesh.axis_names))
    else:
        spec = PartitionSpec(axis_name)
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding that replicates a value on every device."""
    return NamedSharding(mesh, PartitionSpec())
