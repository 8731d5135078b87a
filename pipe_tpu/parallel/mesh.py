"""Device mesh construction.

One canonical mesh shape: ``(channel_shards, time_shards)`` with axis names
:data:`CH_AXIS` and :data:`TIME_AXIS`. The four GPUs of one host are joined
all to all by NVLink, so any device order serves both axes alike; the shape
follows the algorithm (time shards for halo exchange and cross-device
scans, channel shards for work that needs no communication until the final
mixer psum).
"""

from __future__ import annotations

import jax

CH_AXIS = "ch"
TIME_AXIS = "time"


def make_mesh(channel_shards: int = 1, time_shards: int = 1, devices=None):
    """Build a ``(ch, time)`` mesh over the given (or all) devices."""
    n = channel_shards * time_shards
    if devices is None:
        devices = jax.devices()
    if len(devices) < n:
        raise ValueError(
            f"mesh {channel_shards}x{time_shards} needs {n} devices, "
            f"have {len(devices)}"
        )
    return jax.make_mesh(
        (channel_shards, time_shards),
        (CH_AXIS, TIME_AXIS),
        devices=devices[:n],
    )
