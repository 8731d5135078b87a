"""Streaming polyphase resampler (benchmark config 3: 44.1k -> 48k).

Rate change L/M with a polyphase FIR bank. For output index ``j`` at
upsampled position ``u = j*M``: phase ``p = u % L`` selects the subfilter
and ``n0 = u // L`` the newest input sample:

    y[j] = sum_i hp[p, i] * x[n0 - i]        (hp: (L, K) polyphase bank)

Because L/M is rational and blocks are fixed-size, the number of outputs per
input block varies by +-1; the output :class:`~pipe_tpu.signal.Signal` has a
static capacity of ``ceil(B*L/M)`` frames with a dynamic ``frames`` count —
the framework's partial-block protocol mid-stream. Downstream stateful ops
(FIR, OLS) advance their tails by the dynamic frame count, so chains like
FIR -> resample -> FIR are sample-exact.

Hot path (full blocks with ``B % M == 0``): outputs are grouped into
*supercycles* of ``G*M`` inputs -> ``G*L`` outputs, and the whole bank
becomes ONE dense matmul ``y = xw @ W`` with
``W[j, q] = hp[(q*M) % L, K-1 + (q*M)//L - j]`` (zero outside the window) —
a ``(K-1+G*M, G*L)`` Toeplitz-like matrix, one dense contraction. ``W`` is
built inside jit from the traced bank, so ``hp`` mutations never retrace.
The gather+einsum fallback materializes a (C, Bout, K) windows tensor —
pure memory traffic — so it only serves partial blocks / phase offsets.

The gather path remains as the general fallback for partial blocks and
mid-stream phase offsets (a ``lax.cond`` selects per block at runtime).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal, SignalProperties
from pipe_tpu.ops.fir import design_lowpass

from pipe_tpu import config


def polyphase_design(
    up: int, down: int, taps_per_phase: int = 32, beta: float = 12.0
) -> np.ndarray:
    """Design the polyphase bank ``(L, K)`` for an L/M rate change,
    float64 host-side.

    The prototype is a Kaiser-windowed sinc lowpass at the upsampled rate.
    ``beta = 12`` gives ~-120 dB stopband; the cutoff sits at 94% of the
    smaller Nyquist so the transition band stays inside the guard region
    rather than folding aliases onto the passband edge.
    """
    import scipy.signal

    L, M = up, down
    K = taps_per_phase
    # Units where the input rate is 1: the upsampled rate is L and the
    # cutoff is just below the smaller of the input/output Nyquists.
    cutoff = 0.94 * min(0.5, L / (2.0 * M))
    h = scipy.signal.firwin(K * L, cutoff, window=("kaiser", beta), fs=float(L))
    h = np.asarray(h, np.float64) * L
    return h.reshape(K, L).T.copy()  # hp[p, i] = h[i*L + p]


def _reduce_ratio(up: int, down: int):
    g = math.gcd(up, down)
    return up // g, down // g


def resample_apply(hist, x, hp, up: int, down: int, group: int | None = None):
    """Full-block polyphase resample (hot path).

    Args:
      hist: ``(C, K-1)`` carried input history.
      x: ``(C, B)`` input with ``B % down == 0`` (static).
      hp: ``(L, K)`` traced polyphase bank.
      up/down: reduced rate ratio L/M.
      group: supercycles per matmul row (G); default 1.

    Returns ``(C, B*L//M)``. The whole bank is one 2-tap feature conv on
    the device: frames of ``G*M`` samples are features, ``W`` is split into
    the part reading the previous frame (the K-1 overlap) and the current
    frame. Precision is :func:`pipe_tpu.config.matmul_precision`
    (``HIGHEST`` by default; on the GPU the TF32 levels cap the flagship
    near 69 dB).
    """
    L, M = up, down
    C, B = x.shape
    K = hp.shape[1]
    if B % M:
        raise ValueError(f"resample_apply needs B % {M} == 0, got B={B}")
    n_cyc = B // M
    if group is None:
        # G=1 minimizes FLOPs: per input sample the dense supercycle matmul
        # costs 2*n_blk*G*L FLOPs, linear in G (the window widens with G but
        # the useful taps per output stay K). 64 channels x 301,056 frames
        # on an H100 (80GB HBM3, 700 W), benchmarks/sweep.py: G=1 613 us,
        # G=2 834 us, G=4 1412 us, G=8 2586 us.
        group = 1
    G = group
    GM, GL = G * M, G * L
    n_g = B // GM

    # W[j, q] built from the traced bank (see module docstring)
    q = jnp.arange(GL)
    ph = (q * M) % L
    n0 = (q * M) // L
    j = jnp.arange(K - 1 + GM)
    kidx = (K - 1 + n0)[None, :] - j[:, None]  # (K-1+GM, GL)
    valid = (kidx >= 0) & (kidx < K)
    W = jnp.where(valid, hp[ph[None, :], jnp.clip(kidx, 0, K - 1)], 0.0)

    # split W rows into GM-sized frame chunks -> spatial conv taps. Usually
    # n_blk == 2 (previous frame holds the K-1 overlap, current frame the
    # rest); more when the history exceeds one supercycle (K-1 > G*M).
    n_blk = -(-(K - 1) // GM) + 1
    Wp = jnp.zeros((n_blk * GM, GL), W.dtype).at[-(K - 1 + GM):, :].set(W)
    rhs = jnp.stack(
        [Wp[j * GM : (j + 1) * GM, :].T for j in range(n_blk)], axis=-1
    )  # (GL, GM, n_blk)

    left = jnp.zeros((C, (n_blk - 1) * GM), x.dtype)
    if K > 1:
        left = left.at[:, -(K - 1):].set(hist)
    xp = jnp.concatenate([left, x], axis=1)
    frames = xp.reshape(C, n_blk - 1 + n_g, GM)
    lhs = jnp.transpose(frames, (0, 2, 1))  # (C, GM, n_blk-1+n_g)
    out = lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )  # (C, GL, n_g)
    return jnp.transpose(out, (0, 2, 1)).reshape(C, B * L // M)


class Resampler:
    """Polyphase resampling processor: input rate * up/down."""

    def __init__(self, up: int, down: int, taps_per_phase: int = 32):
        if up <= 0 or down <= 0:
            raise ValueError("up/down must be positive")
        self.up, self.down = _reduce_ratio(up, down)
        self.taps_per_phase = taps_per_phase
        self._hp = jnp.asarray(
            polyphase_design(self.up, self.down, taps_per_phase), jnp.float32
        )
        self._component = None
        self._delegate = None  # set by pipe_tpu.optimize.fuse
        self.context = None

    def processor(self):
        L, M = self.up, self.down
        K = self.taps_per_phase
        hp_init = self._hp

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C = props.channels
            B = block_size
            B_out = -(-B * L // M)  # ceil: max outputs per full input block

            def gather_path(hist, off, f, xm, hp):
                """General path: any frame count, any phase offset."""
                ctx = jnp.concatenate([hist, xm], axis=1)  # (C, K-1+B)
                # outputs with upsampled position u = off + t*M < f*L
                t = jnp.arange(B_out, dtype=jnp.int32)
                u = off + t * M
                n_out = jnp.maximum(
                    0, (f * L - off + (M - 1)) // M
                )  # ceil((f*L - off)/M), 0 if off >= f*L
                p = u % L
                n0 = u // L
                ii = jnp.arange(K, dtype=jnp.int32)
                gidx = (K - 1 + n0)[:, None] - ii[None, :]  # (B_out, K)
                gidx = jnp.clip(gidx, 0, ctx.shape[1] - 1)
                windows = ctx[:, gidx]  # (C, B_out, K) gather
                coefs = hp[p]  # (B_out, K)
                y = jnp.einsum(
                    "cbk,bk->cb",
                    windows,
                    coefs,
                    preferred_element_type=jnp.float32,
                    precision=config.matmul_precision(),
                )
                new_hist = lax.dynamic_slice(ctx, (0, f), (C, K - 1))
                new_off = off + n_out * M - f * L
                return y, n_out.astype(jnp.int32), new_hist, new_off

            def step(state, params, sig: Signal):
                hist, off = state["hist"], state["off"]
                f = sig.frames
                idx = jnp.arange(B, dtype=jnp.int32)[None, :]
                xm = jnp.where(idx < f, sig.data, 0.0)
                if B % M == 0 and B >= K - 1:
                    # steady-state fast path: full block, zero phase offset
                    # => one supercycle conv (see resample_apply)
                    def fast(args):
                        hist, off, f, xm, hp = args
                        y = resample_apply(hist, xm, hp, L, M)
                        return (
                            y,
                            jnp.asarray(B * L // M, jnp.int32),
                            xm[:, B - (K - 1):],
                            jnp.asarray(0, jnp.int32),
                        )

                    y, n_out, new_hist, new_off = lax.cond(
                        jnp.logical_and(off == 0, f == B),
                        fast,
                        lambda args: gather_path(*args),
                        (hist, off, f, xm, params["hp"]),
                    )
                else:
                    y, n_out, new_hist, new_off = gather_path(
                        hist, off, f, xm, params["hp"]
                    )
                new_state = {"hist": new_hist, "off": new_off}
                return new_state, Signal(y, n_out)

            self._component = Processor(
                output=SignalProperties(
                    sample_rate=props.sample_rate * L / M, channels=C
                ),
                step=step,
                state={
                    "hist": jnp.zeros((C, K - 1), jnp.float32),
                    "off": jnp.asarray(0, jnp.int32),
                },
                params={"hp": hp_init},
                out_capacity=B_out,  # downstream ops size to this width
            )
            return self._component

        alloc.fusion_tag = ("resample", self)
        return alloc

    def set_bank(self, hp):
        """Mutate the polyphase bank mid-stream (same (L, K) shape);
        retrace-free."""
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_bank(hp)
        b = jnp.asarray(hp, jnp.float32)

        def fn():
            self._component.set_param("hp", b)

        return self.context.mutate(fn)
