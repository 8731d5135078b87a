"""Signal buffers — the L0 of the framework.

Replaces the reference's external ``pipelined.dev/signal`` package (see
SURVEY.md §1 L0 and the call-site API surface in SURVEY.md §2). The reference
uses interleaved float64 slices with pooled allocation; here the layout is
planar ``(channels, frames)`` float32 — frames contiguous, so per-channel
filters stream along memory — and XLA buffer donation replaces the pool
allocator
(reference ``pipe.go:490-492``).

The reference's partial-buffer protocol (``Slice(0, read)`` on short reads,
``pipe.go:404-406``) would be a dynamic shape under jit, so a :class:`Signal`
carries a static-shape data array plus a ``frames`` scalar: the number of
leading frames that are valid. Everything past ``frames`` is garbage that
downstream stages must mask or ignore.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

DEFAULT_DTYPE = jnp.float32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Signal:
    """A fixed-capacity block of multi-channel samples.

    ``data`` has shape ``(channels, block_size)``; ``frames`` (a traced int32
    scalar) is the count of valid leading frames, mirroring the reference's
    short-read ``Slice`` (``pipe.go:404-406``). ``frames == block_size`` for
    full blocks; the only sub-full block in a well-formed stream is the final
    one.
    """

    data: Array
    frames: Array  # int32 scalar, 0 <= frames <= block_size

    @property
    def channels(self) -> int:
        return self.data.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def mask(self) -> Array:
        """``(1, block_size)`` float mask: 1.0 for valid frames, else 0.0."""
        idx = jnp.arange(self.block_size, dtype=jnp.int32)[None, :]
        return (idx < self.frames).astype(self.data.dtype)

    def masked(self) -> "Signal":
        """Return a signal with invalid frames zeroed."""
        return Signal(self.data * self.mask(), self.frames)

    def with_data(self, data: Array) -> "Signal":
        return Signal(data, self.frames)

    def with_frames(self, frames: Union[int, Array]) -> "Signal":
        return Signal(self.data, jnp.asarray(frames, jnp.int32))


@dataclasses.dataclass(frozen=True)
class SignalProperties:
    """Stream metadata threaded source -> processors -> sink during graph
    construction (reference ``line.go:38-41,62-90``)."""

    sample_rate: float
    channels: int

    def __post_init__(self):
        if self.channels <= 0:
            raise ValueError(f"channels must be positive, got {self.channels}")
        if self.sample_rate < 0:
            raise ValueError(f"sample_rate must be >= 0, got {self.sample_rate}")


def silence(channels: int, block_size: int, dtype=DEFAULT_DTYPE) -> Signal:
    """An all-zero full block (the analog of a fresh pool buffer)."""
    return Signal(
        jnp.zeros((channels, block_size), dtype=dtype),
        jnp.asarray(block_size, jnp.int32),
    )


def empty(channels: int, block_size: int, dtype=DEFAULT_DTYPE) -> Signal:
    """An all-zero block with zero valid frames (an EOF placeholder)."""
    return Signal(
        jnp.zeros((channels, block_size), dtype=dtype),
        jnp.asarray(0, jnp.int32),
    )


def from_array(x, frames: Union[int, None] = None, dtype=DEFAULT_DTYPE) -> Signal:
    """Build a Signal from a ``(channels, block)`` array-like."""
    data = jnp.asarray(x, dtype=dtype)
    if data.ndim == 1:
        data = data[None, :]
    if data.ndim != 2:
        raise ValueError(f"expected 1D or 2D array, got shape {np.shape(x)}")
    n = data.shape[1] if frames is None else frames
    return Signal(data, jnp.asarray(n, jnp.int32))


def to_numpy(sig: Signal) -> np.ndarray:
    """Fetch only the valid frames as a host ``(channels, frames)`` array."""
    frames = int(sig.frames)
    return np.asarray(sig.data)[:, :frames]


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-noise ratio of ``test`` against oracle ``ref``, in dB.

    The numeric-fidelity metric for golden tests (SURVEY.md §4: the rebuild
    replaces the reference's reflect.DeepEqual bit-exactness with SNR vs a
    float64 oracle; target >= 100 dB per BASELINE.md).
    """
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    noise = ref - test
    num = float(np.sum(ref * ref))
    den = float(np.sum(noise * noise))
    if den == 0.0:
        return float("inf")
    if num == 0.0:
        return float("-inf")
    return 10.0 * np.log10(num / den)
