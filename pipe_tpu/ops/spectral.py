"""Streaming STFT processing — windowed overlap-add spectral ops.

The reference ships no spectral machinery (it ships no DSP at all —
components live out-of-tree, reference ``doc.go:30-33``); this module adds
the frequency-domain half of a complete DSP kit: a streaming STFT ->
per-bin transform -> weighted-OLA resynthesis engine with *exact* COLA
normalization, plus two processors built on it (a per-bin gain curve and a
spectral noise gate).

Device mapping. All ``B/hop`` analysis windows of a block are framed with
one gather into a ``(C, F, W)`` tensor, transformed by ONE batched ``rfft``,
per-bin math runs as planar f32 re/im arithmetic (the same layout as
``pipe_tpu/ops/ols.py``), and the overlap-add fold is a static
``W/hop``-step shift-and-add over hop-sized panes. No per-window host loop,
no dynamic shapes.

Streaming contract. The engine has the inherent real-time STFT latency of
``W - hop`` samples: output sample ``n`` reconstructs input sample
``n - (W - hop)``. ANY block size and ANY mid-stream partial frame count
are exact (r4): the hop grid anchors to the absolute stream position, and
samples short of the next hop boundary ride a residue carry until the hop
completes — output is emitted in whole hops (a traced valid count), so a
block may emit slightly fewer or more samples than it consumed, converging
on the stream total. The final (EOF) partial block has the usual real-time
STFT trailing edge (plus up to ``hop - 1`` unhopped residue samples).
Per-window transforms must be memoryless across windows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal


def design_stft_window(window_size: int, hop: int):
    """Periodic-Hann analysis/synthesis window pair with exact weighted-OLA
    normalization.

    Returns float32 ``(w_analysis, w_synthesis)`` of shape ``(W,)`` such
    that for any per-bin gain of 1 the resynthesis is exact:
    ``sum_j w_a[t - j*hop] * w_s[t - j*hop] == 1`` for every steady-state
    ``t``. Designed host-side in float64 (control-plane, same policy as
    ``design_lowpass``).
    """
    W, H = int(window_size), int(hop)
    if W <= 0 or H <= 0 or W % H != 0:
        raise ValueError("window_size must be a positive multiple of hop")
    n = np.arange(W, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / W)  # periodic Hann
    if W == H:  # rectangular degenerate case: no overlap
        w = np.ones(W, np.float64)
    # norm[r] = sum_j w[r + j*H]^2 — constant per residue class mod H.
    norm = w.reshape(W // H, H) ** 2
    den = norm.sum(axis=0)
    if np.any(den <= 0):
        raise ValueError("window/hop pair is not invertible (zero overlap sum)")
    w_s = w / np.tile(den, W // H)
    return w.astype(np.float32), w_s.astype(np.float32)


def frame_hops(ext, window_size: int, hop: int, n_frames: int):
    """Frame ``ext`` (C, W-H + F*H) into (C, F, W) hop-aligned windows.

    ``W % hop == 0``, so window f = ext[:, f*H : f*H + W] decomposes into
    ``K = W/H`` hop-sized panes — built as K shifted reshapes concatenated
    on the last axis (pure slice+reshape dataflow, no general gather with
    a (F, W) index array).
    """
    C = ext.shape[0]
    W, H, F = window_size, hop, n_frames
    K = W // H
    panes = [
        ext[:, k * H : k * H + F * H].reshape(C, F, H) for k in range(K)
    ]
    return jnp.concatenate(panes, axis=-1)


def stft_frames(hist, x, window, hop: int):
    """Frame ``concat([hist, x])`` into hop-aligned windows and analyze.

    ``hist``: (C, W-H) carried samples; ``x``: (C, B) with ``B % hop == 0``
    (the hop-aligned fast framing; :func:`spectral_block` handles any B).
    Returns ``(re, im)`` planes of shape (C, F, bins), F = B // hop.
    """
    C, B = x.shape
    W = window.shape[0]
    F = B // hop
    ext = jnp.concatenate([hist, x], axis=1)  # (C, W-H+B)
    wins = frame_hops(ext, W, hop, F) * window  # (C, F, W)
    spec = jnp.fft.rfft(wins, axis=-1)
    return jnp.real(spec).astype(jnp.float32), jnp.imag(spec).astype(jnp.float32)


def _ola_fold(out, hop: int):
    """Overlap-add windows back to samples.

    ``out``: (C, F, W) synthesis-windowed frames, frame f at offset f*hop.
    Returns (C, F*hop + W - hop) accumulated samples. Static ``W/hop``-step
    shift-and-add — each step is one full-block vector add, no scatter.
    """
    C, F, W = out.shape
    K = W // hop
    panes = out.reshape(C, F, K, hop)
    acc = jnp.zeros((C, F + K - 1, hop), out.dtype)
    for k in range(K):  # K is small and static (e.g. 4 for 75% overlap)
        acc = acc.at[:, k : k + F].add(panes[:, :, k])
    return acc.reshape(C, (F + K - 1) * hop)


def spectral_block(state, x, frames, transform, window_a, window_s, hop: int):
    """One streaming spectral block: STFT -> ``transform`` -> weighted OLA,
    for ANY block size and ANY valid frame count (r4).

    The hop grid anchors to the absolute stream position. The carried
    ``hist`` buffer holds the last ``W - H`` processed samples PLUS up to
    ``H - 1`` residue samples short of the next hop boundary (``nres``
    traced); each block completes ``hops = (nres + frames) // H`` new
    windows (a traced count masking a static window capacity) and emits
    exactly ``hops * H`` samples.

    Args:
      state: dict with ``hist`` (C, W-1) input history+residue, ``nres``
        () int32 residue count, ``tail`` (C, W-H) pending OLA output.
      x: (C, B) input block, valid up to ``frames`` (traced int32).
      transform: ``(re, im) -> (re, im)`` over (C, F, bins) planes;
        must be memoryless across windows.
      window_a / window_s: (W,) analysis / synthesis windows
        (see :func:`design_stft_window`).
      hop: hop size.

    Returns ``(new_state, (y, out_frames))`` with ``y`` of static width
    ``ceil((B + H - 1)/H) * H >= B`` and ``out_frames = hops * H`` valid.
    """
    C, B = x.shape
    W = window_a.shape[0]
    H = hop
    L = W - H
    R = H - 1  # residue capacity
    F_cap = (B + R) // H  # max completable windows per block
    idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    xm = jnp.where(idx < frames, x, 0.0)

    nres = state["nres"]
    hops = (nres + frames) // H
    new_nres = nres + frames - hops * H

    # assembly: [hist+residue (L+R) | x at traced offset L+nres]; positions
    # past L + nres + frames are zeros/garbage no valid window reads. The
    # extra R columns keep the new-hist slice (start = hops*H, width L+R)
    # from CLAMPING when hops*H > B - R (clamped starts would shift the
    # carried history).
    ext = jnp.zeros((C, L + 2 * R + B), jnp.float32)
    ext = lax.dynamic_update_slice(ext, state["hist"], (0, 0))
    ext = lax.dynamic_update_slice(ext, xm, (0, L + nres))

    wins = frame_hops(ext, W, H, F_cap) * window_a  # (C, F_cap, W)
    spec = jnp.fft.rfft(wins, axis=-1)
    re = jnp.real(spec).astype(jnp.float32)
    im = jnp.imag(spec).astype(jnp.float32)
    re, im = transform(re, im)
    spec = lax.complex(re.astype(jnp.float32), im.astype(jnp.float32))
    out = jnp.fft.irfft(spec, n=W, axis=-1).astype(jnp.float32) * window_s

    # window w is complete iff its newest hop arrived this block
    win_ok = jnp.arange(F_cap, dtype=jnp.int32) < hops
    out = jnp.where(win_ok[None, :, None], out, 0.0)

    acc = _ola_fold(out, H)  # (C, F_cap*H + L)
    emitted = hops * H
    if L > 0:
        acc = acc.at[:, :L].add(state["tail"])
        new_tail = lax.dynamic_slice(acc, (0, emitted), (C, L))
    else:
        new_tail = state["tail"]
    new_hist = lax.dynamic_slice(ext, (0, emitted), (C, L + R))
    new_state = {"hist": new_hist, "nres": new_nres, "tail": new_tail}
    return new_state, (acc[:, : F_cap * H], emitted)


def spectral_out_capacity(block_size: int, hop: int) -> int:
    """Static output width per block: whole hops covering ``block_size``
    plus a flushing residue (``>= block_size``)."""
    return ((block_size + hop - 1) // hop) * hop


def spectral_init_state(channels: int, window_size: int, hop: int):
    """Zero state: input history + residue (C, W-1), residue count, and
    the pending OLA tail (C, W-H)."""
    L = window_size - hop
    return {
        "hist": jnp.zeros((channels, L + hop - 1), jnp.float32),
        "nres": jnp.zeros((), jnp.int32),
        "tail": jnp.zeros((channels, L), jnp.float32),
    }


class _SpectralBase:
    """Shared allocator plumbing for STFT processors."""

    def __init__(self, window_size: int, hop: int):
        self.window_size = int(window_size)
        self.hop = int(hop)
        self._wa, self._ws = design_stft_window(self.window_size, self.hop)
        self._component = None
        self.context = None

    @property
    def bins(self) -> int:
        return self.window_size // 2 + 1

    @property
    def latency(self) -> int:
        """Group delay in samples (W - hop)."""
        return self.window_size - self.hop

    def _make_processor(self, props, block_size, params, transform):
        wa, ws = jnp.asarray(self._wa), jnp.asarray(self._ws)
        hop = self.hop

        def step(state, p, sig: Signal):
            new_state, (y, out_frames) = spectral_block(
                state,
                sig.data,
                sig.frames,
                lambda re, im: transform(re, im, p),
                wa,
                ws,
                hop,
            )
            return new_state, Signal(y, out_frames)

        self._component = Processor(
            output=props,
            step=step,
            state=spectral_init_state(props.channels, self.window_size, hop),
            params=params,
            # whole hops covering the block (>= block_size): downstream
            # ops size their buffers to this width
            out_capacity=spectral_out_capacity(block_size, hop),
        )
        return self._component


class SpectralGain(_SpectralBase):
    """Per-bin gain curve applied in the STFT domain.

    ``gains`` is ``(bins,)`` shared or ``(C, bins)`` per-channel, a live
    parameter (mutations never recompile). With ``gains == 1`` the engine
    reconstructs the input exactly (up to f32/FFT rounding) delayed by
    ``window_size - hop`` samples — the perfect-reconstruction invariant the
    golden tests pin.
    """

    def __init__(self, window_size: int, hop: int, gains=None):
        super().__init__(window_size, hop)
        if gains is None:
            gains = np.ones(self.bins, np.float32)
        g = jnp.asarray(gains, jnp.float32)
        if g.ndim not in (1, 2) or g.shape[-1] != self.bins:
            raise ValueError(f"gains must be (bins,) or (C, bins) with bins={self.bins}")
        self._init_gains = g

    def processor(self):
        def alloc(mctx, block_size, props):
            g = self._init_gains
            if g.ndim == 2 and g.shape[0] != props.channels:
                raise ValueError(
                    f"per-channel gains for {g.shape[0]} channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx

            def transform(re, im, p):
                gg = p["gains"]
                gg = gg[None, None, :] if gg.ndim == 1 else gg[:, None, :]
                return re * gg, im * gg

            return self._make_processor(
                props, block_size, {"gains": g}, transform
            )

        return alloc

    def set_gains(self, gains):
        """Swap the bin-gain curve mid-stream (shape-compatible)."""
        g = jnp.asarray(gains, jnp.float32)

        def fn():
            self._component.set_param("gains", g)

        return self.context.mutate(fn)


class SpectralGate(_SpectralBase):
    """Per-bin noise gate (downward spectral expander).

    Bins whose magnitude falls below ``threshold`` (linear amplitude) are
    attenuated by ``reduction_db``, with a smooth knee of ``knee_db`` around
    the threshold to avoid hard-switching artifacts. Both threshold and
    reduction are live parameters. Per-window gains are memoryless (the
    deferred-window re-processing rule), so gating is deterministic in the
    stream, independent of block size.
    """

    def __init__(
        self,
        window_size: int,
        hop: int,
        threshold: float,
        reduction_db: float = -80.0,
        knee_db: float = 6.0,
    ):
        super().__init__(window_size, hop)
        self._init_params = {
            "threshold": jnp.float32(threshold),
            "reduction_db": jnp.float32(reduction_db),
        }
        self.knee_db = float(knee_db)

    def processor(self):
        def alloc(mctx, block_size, props):
            self.context = mctx
            knee = max(self.knee_db, 1e-3)

            def transform(re, im, p):
                mag = jnp.sqrt(re * re + im * im) + 1e-30
                over_db = 20.0 * jnp.log10(mag / p["threshold"])
                # 0 -> reduction, 1 -> unity across the knee
                frac = jnp.clip(over_db / knee + 0.5, 0.0, 1.0)
                floor = 10.0 ** (p["reduction_db"] / 20.0)
                gain = floor + (1.0 - floor) * frac
                return re * gain, im * gain

            return self._make_processor(
                props, block_size, dict(self._init_params), transform
            )

        return alloc

    def set_threshold(self, threshold: float):
        def fn():
            self._component.set_param("threshold", jnp.float32(threshold))

        return self.context.mutate(fn)

    def set_reduction(self, reduction_db: float):
        def fn():
            self._component.set_param("reduction_db", jnp.float32(reduction_db))

        return self.context.mutate(fn)
