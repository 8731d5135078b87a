"""Multi-process execution — process group + global mesh construction.

The reference is strictly single-process (SURVEY.md §2: its inter-stage
"backend" is Go channels). Scaling past one process here is the standard
JAX multi-controller recipe: every process runs the same program,
``jax.distributed.initialize`` forms the process group, and the mesh spans
the *global* device set — collectives (the halo ``ppermute``, the mixer
``psum``) then cross process boundaries.

On one host of four GPUs joined all to all by NVLink, ONE process drives
all four cards and this module is not needed: every card reaches every
other at the same rate, so mesh axis order follows the algorithm alone.
The multi-process path is the protocol for several hosts; the tests run it
with CPU-forced processes (``tests/test_distributed.py``). Never start two
JAX processes on one card: each reserves most of its memory.

Usage (same program on every host)::

    from pipe_tpu import parallel
    parallel.initialize()                       # no-op on a single host
    mesh = parallel.make_global_mesh(channel_shards=8, time_shards=4)
    chain = parallel.ShardedChain(mesh, stages, channels=64,
                                  chunk_frames=...)
    # feed per-host shards with jax.make_array_from_process_local_data

On a single host both calls degrade gracefully, so the code is portable
from a laptop CPU mesh to several hosts unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax

from pipe_tpu.parallel.mesh import CH_AXIS, TIME_AXIS

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Form the multi-host process group (idempotent; no-op single-host).

    With no arguments, relies on JAX's cluster auto-detection (a no-op
    where there is no cluster environment); pass ``coordinator_address``
    (e.g. ``localhost:<port>``), ``num_processes`` and ``process_id`` to
    form a group by hand.
    """
    global _initialized
    if _initialized:
        return
    if num_processes is None and coordinator_address is None:
        # Single process with no cluster env: nothing to form.
        env_hints = jax.process_count() > 1
        if not env_hints:
            _initialized = True
            return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True


def make_global_mesh(channel_shards: int = 1, time_shards: int = 1):
    """A ``(ch, time)`` mesh over the GLOBAL device set (all hosts).

    Uses ``jax.make_mesh`` over every process's devices.
    """
    n = channel_shards * time_shards
    total = jax.device_count()
    if total < n:
        raise ValueError(
            f"global mesh {channel_shards}x{time_shards} needs {n} devices, "
            f"cluster has {total}"
        )
    return jax.make_mesh((channel_shards, time_shards), (CH_AXIS, TIME_AXIS))


def shard_host_chunk(mesh, x_local):
    """Assemble a global ``(channels, chunk)`` array from per-host local
    shards (each host passes its slice of the channel x time block grid)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(CH_AXIS, TIME_AXIS)), x_local
    )
