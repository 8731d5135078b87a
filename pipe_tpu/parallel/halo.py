"""Halo exchange primitives (shard_map-internal).

The overlap-save boundary mechanic: when a stream chunk is sharded over the
time axis, each device's stateful ops need the trailing ``halo`` samples of
the *previous* time-block, which live on the left neighbor. ``ppermute``
shifts every device's tail one step right; the first device takes
the carry from the previous chunk instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def halo_from_left(x_local, halo: int, axis_name: str, carried):
    """Return the ``halo`` samples preceding this device's time-block.

    Args:
      x_local: ``(C, N_local)`` this device's chunk slice.
      halo: number of trailing samples each device contributes.
      axis_name: time mesh axis name.
      carried: ``(C, halo)`` stream state carried from the previous chunk
        (used by device 0; replicated input).

    Must be called inside ``shard_map``. ``ppermute`` leaves device 0's
    receive buffer zero (no source permutes into it), and the carry is
    selected there.
    """
    if halo <= 0:
        return x_local[:, :0]
    n = lax.axis_size(axis_name)
    tail = x_local[:, -halo:]
    if n == 1:
        return carried
    left = lax.ppermute(tail, axis_name, perm=[(i, i + 1) for i in range(n - 1)])
    idx = lax.axis_index(axis_name)
    return jnp.where(idx == 0, carried, left)


def last_shard(value, axis_name: str):
    """Replicate the LAST device's ``value`` to every device — how a chunk's
    final stream state (filter tail, IIR state) becomes the next chunk's
    carry. Implemented as an all_gather + static index; the payloads are
    small (tails, 2-vectors)."""
    gathered = lax.all_gather(value, axis_name, axis=0)
    return gathered[-1]


def broadcast_last(value, axis_name: str):
    """Replicate the LAST device's ``value`` to every device, as a masked
    ``psum`` — output bytes are one value per device (vs the all_gather's
    T in :func:`last_shard`), the right choice when the value is LARGE
    (the Delay feedback exit history is O(C*D))."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    return lax.psum(jnp.where(idx == n - 1, value, 0.0), axis_name)


def exclusive_prefix_ladder(axis_name: str, combine, unit, value):
    """Exclusive prefix-combine via a Hillis–Steele ppermute ladder:
    ``ceil(log2(T))`` rounds moving one value-tree per round, instead of
    the all_gather's T copies — the right choice when the per-device value
    is LARGE (the Delay feedback history transfer is O(C*D) bytes; the
    biquad/envelope 2x2 totals are better served by
    :func:`exclusive_prefix`).

    ``combine(left, right)`` must be associative with identity ``unit``.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    def shift_right(tree, hops):
        return jax.tree.map(
            lambda v: lax.ppermute(
                v, axis_name, perm=[(i, i + hops) for i in range(n - hops)]
            ),
            tree,
        )

    def select(pred, new, old):
        return jax.tree.map(lambda a, b: jnp.where(pred, a, b), new, old)

    if n == 1:
        return unit
    # seed: acc_d = v_{d-1} (unit at d=0); inclusive ladder over the seed
    # yields the exclusive prefix
    acc = select(idx == 0, unit, shift_right(value, 1))
    k = 1
    while k < n:
        recv = shift_right(acc, k)
        acc = select(idx >= k, combine(recv, acc), acc)
        k *= 2
    return acc


def exclusive_prefix(axis_name: str, combine, unit, value):
    """Exclusive prefix-combine of per-device values over a mesh axis:
    device d receives ``combine(v_0, ..., v_{d-1})`` (``unit`` for d=0).

    Used to shard IIR recurrences over time: per-device scan totals are
    tiny (2x2 matrices per channel), so an all_gather + local fori_loop is
    cheaper than a log-step ladder at these sizes (see
    :func:`exclusive_prefix_ladder` for the large-payload variant).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    gathered = jax.tree.map(
        lambda v: lax.all_gather(v, axis_name, axis=0), value
    )  # (D, ...)

    def body(d, acc):
        take = jax.tree.map(lambda g: g[d], gathered)
        new = combine(acc, take)
        return jax.tree.map(
            lambda a, b: jnp.where(d < idx, b, a), acc, new
        )

    return lax.fori_loop(0, n, body, unit)
