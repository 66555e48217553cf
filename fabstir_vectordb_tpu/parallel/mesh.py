"""Device mesh construction for multi-chip sharding.

The reference has no collective layer (its "distributed backend" is HTTP to
an S5 portal; SURVEY §2.10): multi-chip scaling is new capability in this
rebuild. Shardings here ride the device interconnect via XLA collectives
(psum / all_gather); HTTP remains the cold-storage path only.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


DATA_AXIS = "data"  # rows / inverted lists sharded over this axis


def cpu_mesh(n_devices: int, axis: str = DATA_AXIS) -> Mesh:
    """Mesh over the virtual CPU host platform (tests / dryrun)."""
    cpus = jax.devices("cpu")
    if len(cpus) < n_devices:
        raise ValueError(
            f"need {n_devices} CPU devices, have {len(cpus)}; set "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n_devices}"
        )
    return Mesh(np.array(cpus[:n_devices]), (axis,))


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """Mesh over the default backend's devices. Raises when the backend has
    fewer than ``n_devices`` (tests build virtual CPU meshes with
    ``cpu_mesh`` explicitly)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if len(devs) < n_devices:
        raise ValueError(
            f"need {n_devices} {devs[0].platform} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis,))
