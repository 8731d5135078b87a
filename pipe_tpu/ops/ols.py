"""Uniformly-partitioned overlap-save FFT convolution (benchmark config 4:
64k-tap convolution reverb).

For an impulse response of P taps and block size B, the IR is split into
``ceil(P/B)`` partitions of B taps. Per block the engine does ONE rfft of
the (2B) input window, a multiply-accumulate against the partition spectra
across a frequency-domain delay line (FDL), and one irfft — O(B log B +
P) per block instead of O(P*B) for direct convolution. This is the
classical UPOLS structure; state is the FDL plus the previous input block,
which is exactly the halo exchanged between devices when time-blocks are
sharded.

Spectra are carried as **separate float32 re/im planes**, not complex64:
the complex multiply-accumulate expands to real einsums at the configured
matmul precision, and complex values exist only across the rfft -> irfft
boundary. (Whether complex64 arithmetic would be faster on the GPU is not
measured.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal

from pipe_tpu import config


def partition_ir(ir: np.ndarray, block_size: int) -> np.ndarray:
    """Split + transform an IR into partition spectra planes.

    ``ir``: (P,) shared or (C, P) per-channel float.
    Returns float32 array (2, n_parts, bins) or (2, n_parts, C, bins) —
    re/im planes of the rfft of 2B-padded partitions, ``bins = B + 1``.
    """
    ir = np.asarray(ir, np.float64)
    shared = ir.ndim == 1
    if shared:
        ir = ir[None, :]
    C, P = ir.shape
    B = block_size
    n_parts = -(-P // B)
    padded = np.zeros((C, n_parts * B), np.float64)
    padded[:, :P] = ir
    parts = padded.reshape(C, n_parts, B).transpose(1, 0, 2)  # (n_parts, C, B)
    spec = np.fft.rfft(np.concatenate([parts, np.zeros_like(parts)], axis=-1), axis=-1)
    planes = np.stack([spec.real, spec.imag]).astype(np.float32)
    if shared:
        return planes[:, :, 0, :]  # (2, n_parts, bins)
    return planes  # (2, n_parts, C, bins)


def ols_init_state(channels: int, block_size: int, n_parts: int):
    """Zero state: previous input block + frequency-domain delay line
    (re/im planes) + the ring head (slot of the NEXT write)."""
    bins = block_size + 1
    return {
        "prev": jnp.zeros((channels, block_size), jnp.float32),
        "fdl": jnp.zeros((2, n_parts, channels, bins), jnp.float32),
        "pos": jnp.zeros((), jnp.int32),
    }


def ols_block(state, x, frames, ir_spec):
    """One UPOLS block.

    The FDL is a RING: block t's spectrum lives in slot ``t mod K`` and is
    written in place (``dynamic_update_slice`` + buffer donation), so the
    per-block state traffic is one slot instead of shifting the whole
    delay line — the shift was the dominant cost of the step (the MAC and
    FFTs are small next to K spectra of memory traffic; docs/PERF_NOTES.md
    "ring buffers"). The MAC alignment moves to the (much smaller) IR
    side: ``acc = sum_q fdl[q] * H_rot[q]`` with
    ``H_rot[q] = H[(s - q) mod K]`` — a roll of the reversed partition
    spectra by the traced head.

    Args:
      state: dict with ``prev`` (C, B), ``fdl`` (2, n_parts, C, bins),
        ``pos`` () int32 — the slot the current block is written to.
      x: (C, B) input block, valid up to ``frames``.
      frames: traced int32.
      ir_spec: (2, n_parts, bins) shared or (2, n_parts, C, bins)
        per-channel partition spectra planes (float32, re/im).

    Returns (new_state, y) with y (C, B).
    """
    C, B = x.shape
    K = state["fdl"].shape[1]
    idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    xm = jnp.where(idx < frames, x, 0.0)
    window = jnp.concatenate([state["prev"], xm], axis=1)  # (C, 2B)
    X = jnp.fft.rfft(window, axis=-1)  # (C, bins) complex64
    Xp = jnp.stack([jnp.real(X), jnp.imag(X)])  # (2, C, bins) float32
    s = state["pos"]
    fdl = jax.lax.dynamic_update_slice(
        state["fdl"], Xp[:, None], (0, s, 0, 0)
    )
    # H_rot[q] = H[(s - q) mod K]: reversed spectra rolled by the head
    h_rot = jnp.roll(ir_spec[:, ::-1], s + 1, axis=1)
    hi = config.matmul_precision()
    fr, fi = fdl[0], fdl[1]  # (n_parts, C, bins)
    if ir_spec.ndim == 3:  # shared IR: (2, n_parts, bins)
        hr, hi_ = h_rot[0], h_rot[1]
        acc_re = jnp.einsum("pcb,pb->cb", fr, hr, precision=hi) - jnp.einsum(
            "pcb,pb->cb", fi, hi_, precision=hi
        )
        acc_im = jnp.einsum("pcb,pb->cb", fr, hi_, precision=hi) + jnp.einsum(
            "pcb,pb->cb", fi, hr, precision=hi
        )
    else:  # per-channel IR: (2, n_parts, C, bins)
        hr, hi_ = h_rot[0], h_rot[1]
        acc_re = jnp.einsum("pcb,pcb->cb", fr, hr, precision=hi) - jnp.einsum(
            "pcb,pcb->cb", fi, hi_, precision=hi
        )
        acc_im = jnp.einsum("pcb,pcb->cb", fr, hi_, precision=hi) + jnp.einsum(
            "pcb,pcb->cb", fi, hr, precision=hi
        )
    acc = jax.lax.complex(acc_re, acc_im)
    y = jnp.fft.irfft(acc, n=2 * B, axis=-1)[:, B:]  # overlap-save: keep tail half
    # `prev` must hold the last B samples of the *valid* stream; with
    # mid-stream partial blocks we shift by `frames` like the FIR tail.
    buf = jnp.concatenate([state["prev"], xm], axis=1)
    prev = jax.lax.dynamic_slice(buf, (0, frames), (C, B))
    return {
        "prev": prev,
        "fdl": fdl,
        "pos": (s + 1) % K,
    }, y.astype(jnp.float32)


class OLSConvolve:
    """Partitioned overlap-save convolution processor. ``ir`` may be (P,)
    shared or (C, P) per-channel. The partition spectra are a live parameter,
    so the reverb IR can be swapped mid-stream (same P)."""

    def __init__(self, ir):
        self._ir = np.asarray(ir)
        self._component = None
        self._delegate = None  # set by pipe_tpu.optimize.fuse
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props):
            self.context = mctx
            spec = jnp.asarray(partition_ir(self._ir, block_size))
            if spec.ndim == 4 and spec.shape[2] != props.channels:
                raise ValueError(
                    f"per-channel IR for {spec.shape[2]} channels, "
                    f"line has {props.channels}"
                )
            n_parts = spec.shape[1]

            def step(state, params, sig: Signal):
                new_state, y = ols_block(
                    state, sig.data, sig.frames, params["ir_spec"]
                )
                return new_state, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state=ols_init_state(props.channels, block_size, n_parts),
                params={"ir_spec": spec},
            )
            return self._component

        alloc.fusion_tag = ("ols", self)
        return alloc

    def set_ir(self, ir):
        """Swap the impulse response mid-stream (shape-compatible)."""
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_ir(ir)

        def fn():
            block_size = self._component.state["prev"].shape[1]
            self._component.set_param(
                "ir_spec", jnp.asarray(partition_ir(np.asarray(ir), block_size))
            )

        return self.context.mutate(fn)
