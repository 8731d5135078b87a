"""Streaming FIR filtering (benchmark config 3: 255-tap lowpass).

The reference leaves filter tails inside component closures (SURVEY.md §5
'long-context': no inter-buffer overlap mechanism exists). Here the tail is
explicit state — ``(C, T-1)`` trailing samples — which is exactly what makes
time-block sharding possible later: the tail is the halo that ``ppermute``
exchanges between neighboring block owners (``pipe_tpu.parallel.halo``).

Hot path (shared taps, block >= 128 frames): the signal is reframed into
``S``-sample frames treated as *features*, and the FIR becomes ONE
``lax.conv_general_dilated`` with ``S`` input features, ``S`` output
features, and ``ceil((T-1)/S)+1`` spatial taps whose kernel stacks the
block-Toeplitz slices of the taps: dense S x S contractions that XLA hands
to its convolution kernels, where the depthwise (feature-count-1) conv
would do T multiply-adds per sample one tap at a time. The frame size S is
``_FRAME`` (set from the card's timings, ``benchmarks/sweep.py``).

The Toeplitz kernel is built *inside* jit from the traced tap vector, so
``set_taps`` mutations remain retrace-free. Dynamic ``frames`` (partial
blocks) are handled by masking the invalid region before the conv (causal
FIR output ``y[i]`` only reads inputs ``<= i``, so valid outputs never see
masked garbage) and advancing the tail by a dynamic slice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal

from pipe_tpu import config


def fir_init_tail(channels: int, num_taps: int, dtype=jnp.float32):
    """Zero tail state ``(C, T-1)``."""
    return jnp.zeros((channels, max(num_taps - 1, 0)), dtype=dtype)


def _conv_valid(buf, taps_rev):
    """Depthwise valid 1D correlation.

    ``buf``: (C, L). ``taps_rev``: (T,) shared or (C, T) per-channel,
    already reversed so the correlation computes the causal convolution
    ``y[n] = sum_k h[k] x[n-k]``.
    """
    C = buf.shape[0]
    if taps_rev.ndim == 1:
        # shared filter: batch over channels
        lhs = buf[:, None, :]  # (C, 1, L)
        rhs = taps_rev[None, None, :]  # (1, 1, T)
        out = lax.conv_general_dilated(
            lhs,
            rhs,
            window_strides=(1,),
            padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=jnp.float32,
            precision=config.matmul_precision(),
        )
        return out[:, 0, :]  # (C, B)
    # per-channel filters: grouped conv
    lhs = buf[None, :, :]  # (1, C, L)
    rhs = taps_rev[:, None, :]  # (C, 1, T)
    out = lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding="VALID",
        feature_group_count=C,
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )
    return out[0]  # (C, B)


def _toeplitz_kernel(taps, S: int, n_blk: int):
    """Stack the block-Toeplitz slices of ``taps`` into a conv kernel.

    Returns (S_out, S_in, n_blk) where tap ``j`` (spatial position) holds
    ``H_{n_blk-1-j}`` with ``H_t[i, m] = taps[t*S + i - m]`` (zero outside
    ``[0, T)``) — so a VALID conv over the frame axis computes
    ``y_w = sum_t frames[w + (n_blk-1) - t] @ H_t^T`` = the causal FIR.
    Built from the traced tap vector: tap mutations never retrace.
    """
    T = taps.shape[-1]
    i = jnp.arange(S)[:, None, None]  # output position within frame
    m = jnp.arange(S)[None, :, None]  # input position within frame
    j = jnp.arange(n_blk)[None, None, :]  # spatial tap (reversed block idx)
    t = n_blk - 1 - j
    k = t * S + i - m  # tap index
    valid = (k >= 0) & (k < T)
    return jnp.where(valid, taps[jnp.clip(k, 0, T - 1)], 0.0)


# Frame size S of the Toeplitz path. The kernel is (S, S, n_blk) but only
# ~T of each column is nonzero, so FLOPs per sample (2*S*n_blk) grow with S
# while the work does not; small S means more, smaller contractions.
# 255 taps x 64 channels x 301,056 frames on an H100 (80GB HBM3, 700 W),
# benchmarks/sweep.py: S=32 631 us, S=64 572 us, S=128 637 us, S=256 759 us.
_FRAME = 64


def fir_apply(tail, x, taps):
    """FIR over a fully-valid block: ``tail`` (C, T-1) left context,
    ``x`` (C, B). Returns y (C, B). Static-shape core shared by the
    streaming op (:func:`fir_block`) and the sharded chain
    (:class:`pipe_tpu.parallel.FIRStage`)."""
    C, B = x.shape
    T = taps.shape[-1]
    if taps.ndim != 1 or T < 32 or B < 128:
        # small filters: the depthwise conv is cheap and avoids the
        # S x S Toeplitz overhead; per-channel taps keep the grouped conv.
        buf = jnp.concatenate([tail, x], axis=1)
        return _conv_valid(buf, jnp.flip(taps, -1))
    return _fir_frames(tail, x, taps, _FRAME)


def _fir_frames(tail, x, taps, S: int):
    """The block-Toeplitz FIR with ``S``-sample frames (see module doc)."""
    C, B = x.shape
    T = taps.shape[-1]
    Bp = -(-B // S) * S
    n_blk = -(-(T - 1) // S) + 1
    pad = S * (n_blk - 1)
    kern = _toeplitz_kernel(taps, S, n_blk)
    left = jnp.zeros((C, pad), x.dtype)
    if T > 1:
        left = left.at[:, -(T - 1):].set(tail)
    xp = jnp.concatenate([left, x], axis=1)
    if Bp != B:
        xp = jnp.pad(xp, ((0, 0), (0, Bp - B)))
    frames_ = xp.reshape(C, n_blk - 1 + Bp // S, S)
    lhs = jnp.transpose(frames_, (0, 2, 1))  # (C, S, W')
    out = lax.conv_general_dilated(
        lhs,
        kern,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )  # (C, S, W)
    y = jnp.transpose(out, (0, 2, 1)).reshape(C, Bp)
    return y[:, :B] if Bp != B else y


def fir_block(tail, x, frames, taps):
    """One streaming FIR block.

    Args:
      tail: ``(C, T-1)`` carried history.
      x: ``(C, B)`` input block (only ``[:, :frames]`` valid).
      frames: traced int32 valid-frame count.
      taps: ``(T,)`` shared or ``(C, T)`` per-channel coefficients.

    Returns ``(new_tail, y)`` with ``y`` of shape ``(C, B)``; outputs beyond
    ``frames`` are garbage the caller must mask/ignore (same contract as the
    input).
    """
    C, B = x.shape
    T = taps.shape[-1]
    idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    xm = jnp.where(idx < frames, x, 0.0)
    y = fir_apply(tail, xm, taps)
    # The stream's last T-1 valid samples start at offset `frames` into buf.
    buf = jnp.concatenate([tail, xm], axis=1)  # (C, T-1+B)
    new_tail = lax.dynamic_slice(buf, (0, frames), (C, T - 1))
    return new_tail, y


class FIR:
    """FIR processor factory. ``taps`` may be ``(T,)`` (shared across
    channels) or ``(C, T)`` (per-channel). Coefficients are a live parameter
    (tap shape must stay fixed across mutations)."""

    def __init__(self, taps):
        self._init_taps = jnp.asarray(taps, jnp.float32)
        if self._init_taps.ndim not in (1, 2):
            raise ValueError("taps must be (T,) or (C, T)")
        self._component = None
        self._delegate = None  # set by pipe_tpu.optimize.fuse
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props):
            taps = self._init_taps
            if taps.ndim == 2 and taps.shape[0] != props.channels:
                raise ValueError(
                    f"per-channel taps for {taps.shape[0]} channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx
            T = taps.shape[-1]

            def step(state, params, sig: Signal):
                new_tail, y = fir_block(
                    state["tail"], sig.data, sig.frames, params["taps"]
                )
                return {"tail": new_tail}, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state={"tail": fir_init_tail(props.channels, T)},
                params={"taps": taps},
            )
            return self._component

        alloc.fusion_tag = ("fir", self)
        return alloc

    def set_taps(self, taps):
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_taps(taps)
        t = jnp.asarray(taps, jnp.float32)

        def fn():
            self._component.set_param("taps", t)

        return self.context.mutate(fn)


def design_lowpass(num_taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    """Windowed-sinc (Hamming) lowpass design, float64 on the host.

    Filter *design* happens host-side in float64 (it's control-plane, not
    hot-path); only the application runs on the device in f32.
    """
    if num_taps < 1:
        raise ValueError("num_taps must be >= 1")
    fc = cutoff / sample_rate
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.hamming(num_taps)
    h /= np.sum(h)
    return h
