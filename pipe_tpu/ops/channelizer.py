"""Polyphase DFT filterbank channelizer (critically sampled analysis
bank) — the SDR workhorse: splits a wideband stream into K uniformly
spaced subbands, each lowpass-filtered and decimated by K, for the cost
of one polyphase FIR per branch plus one K-point FFT per output frame.

Math (standard polyphase decomposition): the k-th channel is
``y_k[m] = sum_n x[n] e^{-j2πkn/K} h[mK - n]``. Writing ``n = rK + p``,

    u_p[m] = sum_r x[rK + p] * g_p[m - r],   g_p[s] = h[sK - p]
    y[k, m] = DFT_K over p of u_p[m]

so the bank is K branch FIRs (the prototype's polyphase components on the
K-fold decimated input phases) followed by an FFT across branches. For
real input only the first K/2+1 bins are unique (Hermitian symmetry) —
the rfft across branches yields them directly.

Device mapping: the branch FIRs run as ONE grouped conv over C*K branches
(few taps each); the FFT batches over output frames. Complex values exist
only at the FFT output and are immediately split into re/im float32 planes
(the layout of ``pipe_tpu.ops.ols``).

Signal layout: a channelized stream doesn't fit the framework's
``(channels, frames)`` model as complex subbands, so the Processor emits
``C * 2 * (K//2+1)`` output channels at rate ``sr/K``, ordered
``[c0_bin0_re, c0_bin0_im, c0_bin1_re, ..., c1_bin0_re, ...]`` —
:func:`split_bins` reassembles ``(C, K//2+1, M)`` complex on the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal, SignalProperties

from pipe_tpu import config


def design_prototype(num_channels: int, taps_per_branch: int = 16,
                     beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype lowpass for a K-channel bank,
    cutoff at the channel Nyquist (1/(2K)); float64 host-side."""
    import scipy.signal

    K = num_channels
    n = K * taps_per_branch
    h = scipy.signal.firwin(n, 1.0 / K, window=("kaiser", beta))
    return np.asarray(h, np.float64)


def polyphase_branches(h: np.ndarray, num_channels: int) -> np.ndarray:
    """Branch filters ``g_p[s] = h[sK - p]`` as a ``(K, S)`` array
    (``S = taps_per_branch + 1``, zero-padded where sK - p is out of
    range)."""
    K = num_channels
    P = h.shape[0]
    S = -(-P // K) + 1
    g = np.zeros((K, S), np.float64)
    for p in range(K):
        for s in range(S):
            idx = s * K - p
            if 0 <= idx < P:
                g[p, s] = h[idx]
    return g


def channelize_block(hist, x, gp, num_channels: int):
    """One aligned window through the bank.

    Args:
      hist: ``(C, K*(S-1))`` carried input samples (branch FIR tails in
        input-sample form), ending at a polyphase group boundary.
      x: ``(C, W)`` aligned samples with ``W % K == 0`` (garbage beyond the
        caller's valid count is allowed — outputs there are masked by the
        caller).
      gp: ``(K, S)`` traced branch filters.
      num_channels: K.

    Returns ``(re, im)`` with re/im ``(C, K//2+1, W//K)``.
    """
    K = num_channels
    C, W = x.shape
    S = gp.shape[1]
    if W % K:
        raise ValueError(f"window must be a multiple of K={K}, got {W}")
    M = W // K
    ctx = jnp.concatenate([hist, x], axis=1)  # (C, K*(S-1) + W)
    # phase decompose: u_p input x_p[r] = ctx[rK + p]; frame r spans history
    frames = ctx.reshape(C, S - 1 + M, K)  # frames[c, r, p] = ctx[rK+p]
    # branch FIR: u_p[m] = sum_s x_p[m - s] g_p[s]
    #           = sum_s frames[c, (S-1) + m - s, p] * gp[p, s]
    # One conv over the frame axis with K feature groups:
    lhs = jnp.transpose(frames, (0, 2, 1))  # (C, K, S-1+M)
    rhs = jnp.flip(gp, -1)[:, None, :]  # (K, 1, S) grouped
    u = lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(1,),
        padding="VALID",
        feature_group_count=K,
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )  # (C, K, M)
    Y = jnp.fft.rfft(jnp.transpose(u, (0, 2, 1)), axis=-1)  # (C, M, K//2+1)
    Y = jnp.transpose(Y, (0, 2, 1))  # (C, K//2+1, M)
    return jnp.real(Y), jnp.imag(Y)


def split_bins(data: np.ndarray, num_channels: int) -> np.ndarray:
    """Host helper: reassemble the Processor's stacked-channel output
    ``(C*2*(K//2+1), M)`` into complex ``(C, K//2+1, M)``."""
    K = num_channels
    bins = K // 2 + 1
    C = data.shape[0] // (2 * bins)
    d = data.reshape(C, bins, 2, -1)
    return d[:, :, 0, :] + 1j * d[:, :, 1, :]


class Channelizer:
    """K-channel analysis filterbank processor. The prototype filter is a
    live parameter (same length across mutations)."""

    def __init__(self, num_channels: int, taps_per_branch: int = 16):
        if num_channels < 2 or num_channels % 2:
            raise ValueError("num_channels must be even and >= 2")
        self.num_channels = num_channels
        self.taps_per_branch = taps_per_branch
        self._gp = jnp.asarray(
            polyphase_branches(
                design_prototype(num_channels, taps_per_branch), num_channels
            ),
            jnp.float32,
        )
        self._component = None
        self.context = None

    def processor(self):
        K = self.num_channels
        gp_init = self._gp
        S = int(gp_init.shape[1])
        bins = K // 2 + 1

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C = props.channels
            B = block_size
            H = K * (S - 1)

            def step(state, params, sig: Signal):
                # A mid-stream partial block leaves the stream at an
                # arbitrary position mod K, so up to K-1 valid samples are
                # held over ("pend") until the next block completes their
                # polyphase group — keeping phase assignment exact (the
                # analog of the resampler's phase-offset state). ANY block
                # size works: the pend carry also absorbs a block size not
                # a multiple of K (r4).
                idx = jnp.arange(B, dtype=jnp.int32)[None, :]
                xm = jnp.where(idx < sig.frames, sig.data, 0.0)
                pend, pcnt = state["pend"], state["pcnt"]  # (C, K-1), int32
                # tail region: [pend(:pcnt) | xm | zeros], padded to a whole
                # number of polyphase groups
                Wcap = (-(-(B + K - 1) // K)) * K  # >= pcnt + frames
                pend_m = jnp.where(
                    jnp.arange(K - 1, dtype=jnp.int32)[None, :] < pcnt, pend, 0.0
                )
                tailp = jnp.zeros((C, Wcap + B), jnp.float32)
                tailp = tailp.at[:, : K - 1].set(pend_m)
                tailp = lax.dynamic_update_slice(tailp, xm, (0, pcnt))
                tail = tailp[:, :Wcap]
                total = pcnt + sig.frames
                g = total // K  # whole groups ready (g <= Wcap//K)

                re, im = channelize_block(state["hist"], tail, params["gp"], K)
                out = jnp.stack([re, im], axis=2)  # (C, bins, 2, Wcap//K)
                out = out.reshape(C * bins * 2, Wcap // K)

                # advance: processed stream ends at group boundary g*K.
                # The K-1 pad columns past Wcap keep the pend slice from
                # clamping at g*K == Wcap - pcnt + ... (any-block r4).
                ctx = jnp.concatenate(
                    [state["hist"], tailp[:, : Wcap + K - 1]], axis=1
                )
                new_hist = lax.dynamic_slice(ctx, (0, g * K), (C, H))
                rem_start = H + g * K
                new_pend = lax.dynamic_slice(ctx, (0, rem_start), (C, K - 1))
                return (
                    {"hist": new_hist, "pend": new_pend, "pcnt": total - g * K},
                    Signal(out, g),
                )

            Wcap0 = (-(-(B + K - 1) // K)) * K
            self._component = Processor(
                output=SignalProperties(
                    sample_rate=props.sample_rate / K,
                    channels=C * bins * 2,
                ),
                step=step,
                state={
                    "hist": jnp.zeros((C, H), jnp.float32),
                    "pend": jnp.zeros((C, K - 1), jnp.float32),
                    "pcnt": jnp.asarray(0, jnp.int32),
                },
                params={"gp": gp_init},
                out_capacity=Wcap0 // K,  # decimated group width
            )
            return self._component

        return alloc

    def set_prototype(self, h):
        """Swap the prototype lowpass mid-stream (same length)."""
        gp = jnp.asarray(
            polyphase_branches(np.asarray(h, np.float64), self.num_channels),
            jnp.float32,
        )

        def fn():
            self._component.set_param("gp", gp)

        return self.context.mutate(fn)
