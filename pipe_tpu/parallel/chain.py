"""ShardedChain — the bulk/throughput runner over a device mesh.

Where the streaming runtime (``pipe_tpu.runtime``) advances one block at a
time on one chip, the sharded chain processes a large chunk per step with
the channel axis sharded as data parallelism and the time axis sharded as
sequence parallelism. Stream state (filter tails, IIR states, OLS history)
crosses the device boundary as halos: each device receives its left
neighbor's trailing samples via ``ppermute`` (``halo.halo_from_left``), and
a chunk's final state is re-broadcast as the next chunk's carry
(``halo.last_shard``) — so chunked+sharded output is bit-identical in
structure to the sequential stream.

All stage parameters are traced inputs: retuning a filter or a mix matrix
between chunks never recompiles.

Stage coverage (BASELINE.json config 5 chain and friends):

- :class:`GainStage`      — elementwise, no communication
- :class:`FIRStage`       — (T-1)-sample halo
- :class:`ResampleStage`  — polyphase L/M; requires ``N_local*L % M == 0``
  so every device emits an equal, static output count (phase offset is then
  identical at every boundary)
- :class:`OLSStage`       — overlap-save FFT convolution; P-sample halo,
  or for IRs longer than the local chunk a DISTRIBUTED partitioned FDL
  (bins sharded over the time axis, two all_to_all transposes per step)
- :class:`BiquadStage`    — IIR sharded over time on the tiled Toeplitz
  kernel: per-device zero-state responses plus a cross-device exclusive
  prefix of 2x2 affine totals, then a rank-2 boundary correction and one
  refinement pass (see :func:`_sharded_iir`)
- :class:`MixStage`       — (C_out, C_in) matrix mix reduced with ``psum``
  over the channel axis: the 'merged mixer sink'. Must be last.
"""

from __future__ import annotations

from functools import partial
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from pipe_tpu import config
from pipe_tpu.errors import ShapeConstraintError
from pipe_tpu.parallel.mesh import CH_AXIS, TIME_AXIS
from pipe_tpu.parallel.halo import (
    exclusive_prefix,
    broadcast_last,
    halo_from_left,
    last_shard,
)
from pipe_tpu.ops.fir import fir_apply
from pipe_tpu.ops.resample import resample_apply
from pipe_tpu.ops.biquad import _affine_combine


class Stage:
    """Build-time protocol. ``build(c_global, c_local, n_local)`` fixes
    shapes; carries are GLOBAL arrays (shard_map shards them by
    ``carry_spec``) while ``apply`` sees the local view.

    The builder (``ShardedChain`` / ``parallel.components``) sets
    ``time_shards`` to the mesh time-axis size before calling ``build`` —
    stages whose carry layout depends on the axis size (the bin-sharded
    OLS FDL) read it there; everyone else ignores it.

    **Channel padding** (r4, VERDICT r3 item 3): when the user channel
    count does not divide the mesh channel axis, the builder pads
    ``c_global`` up to the next multiple and sets ``c_user`` to the real
    count before ``build``. Pad channels carry zeros end to end (every
    stage maps zero rows to zero rows), so stages only need to (a) size
    carries by the padded ``c_global`` — automatic — and (b) validate /
    zero-pad their per-channel parameters via :meth:`pad_channels`.
    Stages whose channel layout is positional (the I/Q rail family) set
    ``channel_pad_safe = False`` and keep the divisibility requirement."""

    time_shards: int = 1
    #: real (user) input channel count when the builder padded c_global;
    #: None = no padding
    c_user: Optional[int] = None
    #: False for stages whose channel layout breaks under trailing pad
    #: rows (I/Q half-split rails)
    channel_pad_safe: bool = True
    #: user-visible output channel count (set by build when it differs
    #: from out_c_global under padding; the builder defaults it)
    out_c_user: Optional[int] = None

    def user_channels(self, c_global: int) -> int:
        return c_global if self.c_user is None else self.c_user

    def pad_channels(self, arr, c_global: int, what: str):
        """Validate a per-channel parameter's leading dim against the
        USER channel count and zero-pad it to the (possibly padded)
        ``c_global``."""
        c_user = self.user_channels(c_global)
        if arr.shape[0] != c_user:
            raise ValueError(
                f"per-channel {what} for {arr.shape[0]} channels, "
                f"chain has {c_user}"
            )
        if arr.shape[0] == c_global:
            return arr
        pad = jnp.zeros(
            (c_global - arr.shape[0],) + tuple(arr.shape[1:]), arr.dtype
        )
        return jnp.concatenate([arr, pad], axis=0)

    def build(self, c_global: int, c_local: int, n_local: int):
        raise NotImplementedError

    # populated by build():
    carry: Any = None
    params: Any = None
    carry_spec: Any = None
    param_spec: Any = None
    out_c_local: int = 0
    out_n_local: int = 0

    def apply(self, carry, params, x_local):
        raise NotImplementedError


class GainStage(Stage):
    def __init__(self, gain=1.0):
        self._gain = gain

    def build(self, c_global, c_local, n_local):
        g = jnp.asarray(self._gain, jnp.float32)
        if g.ndim == 1:
            g = self.pad_channels(g, c_global, "gain")
        self.carry = ()
        self.params = {"gain": g}
        self.carry_spec = ()
        # scalar gain replicates; a per-channel vector shards with the rows
        self.param_spec = {"gain": P() if g.ndim == 0 else P(CH_AXIS)}
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def apply(self, carry, params, x):
        g = params["gain"]
        if g.ndim == 1:
            g = g[:, None]
        return (), x * g


class FIRStage(Stage):
    """FIR with (T-1) halo. Taps may be shared ``(T,)`` (replicated over the
    mesh) or per-channel ``(C, T)`` (sharded over CH_AXIS with the
    channels)."""

    def __init__(self, taps):
        self._taps = jnp.asarray(taps, jnp.float32)
        if self._taps.ndim not in (1, 2):
            raise ValueError("FIRStage taps must be (T,) or (C, T)")

    def build(self, c_global, c_local, n_local):
        T = self._taps.shape[-1]
        if self._taps.ndim == 2:
            self._taps = self.pad_channels(self._taps, c_global, "taps")
        if T - 1 > n_local:
            raise ShapeConstraintError(
                f"FIR halo {T-1} exceeds local chunk {n_local}; "
                "use a larger chunk or fewer time shards"
            )
        self.carry = {"tail": jnp.zeros((c_global, T - 1), jnp.float32)}
        self.params = {"taps": self._taps}
        self.carry_spec = {"tail": P(CH_AXIS, None)}
        self.param_spec = {
            "taps": P() if self._taps.ndim == 1 else P(CH_AXIS, None)
        }
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def apply(self, carry, params, x):
        T = params["taps"].shape[-1]
        left = halo_from_left(x, T - 1, TIME_AXIS, carry["tail"])
        y = fir_apply(left, x, params["taps"])
        new_tail = last_shard(x[:, -(T - 1):], TIME_AXIS)
        return {"tail": new_tail}, y


class FIRCascadeStage(FIRStage):
    """A run of FIRs as ONE sharded stage (the sharded twin of
    ``ops.fused.FIRCascade``): the combined taps are rebuilt inside the
    step from the traced member taps (per-slot live retunes,
    recompile-free); one halo of ``sum(T_i - 1)`` samples instead of one
    per stage. Applies via :meth:`FIRStage.apply` with the combined
    bank."""

    def __init__(self, taps_list):
        self._taps = [jnp.asarray(t, jnp.float32) for t in taps_list]
        for t in self._taps:
            if t.ndim not in (1, 2):
                raise ValueError("FIR taps must be (T,) or (C, T)")

    def build(self, c_global, c_local, n_local):
        self._taps = [
            self.pad_channels(t, c_global, "taps") if t.ndim == 2 else t
            for t in self._taps
        ]
        Tc = sum(t.shape[-1] for t in self._taps) - (len(self._taps) - 1)
        if Tc - 1 > n_local:
            raise ShapeConstraintError(
                f"cascaded FIR halo {Tc-1} exceeds local chunk {n_local}"
            )
        self.carry = {"tail": jnp.zeros((c_global, Tc - 1), jnp.float32)}
        self.params = {f"taps{i}": t for i, t in enumerate(self._taps)}
        self.carry_spec = {"tail": P(CH_AXIS, None)}
        self.param_spec = {
            f"taps{i}": P() if t.ndim == 1 else P(CH_AXIS, None)
            for i, t in enumerate(self._taps)
        }
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        from pipe_tpu.ops.fused import cascade_taps

        hc = cascade_taps(
            [params[f"taps{i}"] for i in range(len(self._taps))]
        )
        return super().apply(carry, {"taps": hc}, x)


class ResampleStage(Stage):
    def __init__(self, up: int, down: int, taps_per_phase: int = 32):
        from pipe_tpu.ops.resample import _reduce_ratio, polyphase_design

        self.up, self.down = _reduce_ratio(up, down)
        self.K = taps_per_phase
        self._hp = jnp.asarray(
            polyphase_design(self.up, self.down, taps_per_phase), jnp.float32
        )

    def build(self, c_global, c_local, n_local):
        L, M, K = self.up, self.down, self.K
        if (n_local * L) % M != 0:
            raise ShapeConstraintError(
                f"ResampleStage needs N_local*{L} divisible by {M}; "
                f"got N_local={n_local}"
            )
        if K - 1 > n_local:
            raise ShapeConstraintError("resampler halo exceeds local chunk")
        self.carry = {"hist": jnp.zeros((c_global, K - 1), jnp.float32)}
        self.params = {"hp": self._hp}
        self.carry_spec = {"hist": P(CH_AXIS, None)}
        self.param_spec = {"hp": P()}
        self.out_c_global, self.out_c_local = c_global, c_local
        self.out_n_local = n_local * L // M

    def apply(self, carry, params, x):
        L, M, K = self.up, self.down, self.K
        left = halo_from_left(x, K - 1, TIME_AXIS, carry["hist"])
        # device-local phase starts at 0 by the N_local*L % M divisibility rule
        y = resample_apply(left, x, params["hp"], L, M)
        new_hist = last_shard(x[:, -(K - 1):], TIME_AXIS)
        return {"hist": new_hist}, y


class FIRResampleStage(Stage):
    """Fused FIR + polyphase resample (see ``pipe_tpu.ops.fused``): one
    combined bank, one supercycle matmul, one halo of ``K + T - 2``
    samples instead of two stages with two halos."""

    def __init__(self, taps, up: int, down: int, taps_per_phase: int = 32):
        from pipe_tpu.ops.resample import _reduce_ratio, polyphase_design

        self._taps = jnp.asarray(taps, jnp.float32)
        if self._taps.ndim != 1:
            raise ValueError("FIRResampleStage uses shared (T,) taps")
        self.up, self.down = _reduce_ratio(up, down)
        self.K = taps_per_phase
        self._hp = jnp.asarray(
            polyphase_design(self.up, self.down, taps_per_phase), jnp.float32
        )

    def build(self, c_global, c_local, n_local):
        L, M = self.up, self.down
        Kc = self.K + self._taps.shape[0] - 1
        if (n_local * L) % M != 0:
            raise ShapeConstraintError(
                f"FIRResampleStage needs N_local*{L} divisible by {M}; "
                f"got N_local={n_local}"
            )
        if Kc - 1 > n_local:
            raise ShapeConstraintError("fused halo exceeds local chunk")
        self.carry = {"hist": jnp.zeros((c_global, Kc - 1), jnp.float32)}
        self.params = {"taps": self._taps, "hp": self._hp}
        self.carry_spec = {"hist": P(CH_AXIS, None)}
        self.param_spec = {"taps": P(), "hp": P()}
        self.out_c_global, self.out_c_local = c_global, c_local
        self.out_n_local = n_local * L // M

    def apply(self, carry, params, x):
        from pipe_tpu.ops.fused import combine_bank

        L, M = self.up, self.down
        Kc = self.K + params["taps"].shape[0] - 1
        hc = combine_bank(params["taps"], params["hp"])
        left = halo_from_left(x, Kc - 1, TIME_AXIS, carry["hist"])
        y = resample_apply(left, x, hc, L, M)
        new_hist = last_shard(x[:, -(Kc - 1):], TIME_AXIS)
        return {"hist": new_hist}, y


class OLSStage(Stage):
    """Overlap-save FFT convolution, time-sharded, for ANY IR length.

    Two regimes, chosen at build:

    - **single-FFT** (``P <= n_local``): each device convolves
      [P-sample halo, local chunk] with one FFT sized to the next power of
      two >= P + N_local and keeps the last N_local outputs.
    - **distributed partitioned FDL** (``P > n_local`` — the 64k-tap reverb
      of BASELINE config 4): UPOLS with partition size ``B = n_local``,
      with the frequency-domain delay line SHARDED over the time axis by
      frequency bins. The classical 2B analysis window spectrum decomposes
      linearly over zero-padded block FFTs: with ``A_j = rfft(x_j, 2B)``
      and the B-sample shift phase ``sigma_k = (-1)^k``,
      ``W_g = A_{g-1} + sigma * A_g``, so the window halo folds into the
      partition spectra once at build: ``G_0 = sigma*H_0``,
      ``G_m = sigma*H_m + H_{m-1}``, ``G_K = H_{K-1}`` and
      ``y_g = last B of irfft(sum_{m=0}^{K} G_m A_{g-m})``.

      Per chunk step each device FFTs only its OWN block (no neighbor
      halo), one ``all_to_all`` transposes the T fresh block spectra to a
      bins-over-devices layout, every device multiply-accumulates its bin
      slice of the K+1-deep A-spectra delay line against its bin slice of
      G for ALL T outputs, and a second ``all_to_all`` brings each output
      block's spectrum home for the inverse FFT. The FDL carry and the
      partition spectra are bin-sharded (carry memory and param bytes /T);
      per-step collective traffic is two spectrum-sized transposes,
      independent of T and K — vs the former all_gather of all T window
      spectra plus a (K-1)-deep carry replicated on every device.
    """

    def __init__(self, ir):
        self._ir = np.asarray(ir, np.float64)
        if self._ir.ndim not in (1, 2):
            raise ValueError("OLSStage ir must be (P,) or (C, P)")

    def build(self, c_global, c_local, n_local):
        Pn = self._ir.shape[-1]
        if self._ir.ndim == 2 and self._ir.shape[0] != c_global:
            c_user = self.user_channels(c_global)
            if self._ir.shape[0] != c_user:
                raise ValueError(
                    f"per-channel IR for {self._ir.shape[0]} channels, "
                    f"chain has {c_user}"
                )
            self._ir = np.concatenate(
                [self._ir, np.zeros((c_global - c_user, Pn), np.float64)],
                axis=0,
            )
        self._partitioned = Pn > n_local
        if self._partitioned:
            B = n_local
            K = -(-Pn // B)
            self._F = 2 * B
            self._K = K
            bins = B + 1
            T = max(1, int(self.time_shards))
            self._t = T
            # bins padded to the transpose width (T equal slices)
            self._bs = -(-bins // T)
            self._bins_pad = self._bs * T
            self.carry = {
                # zfdl[i] = A-spectrum planes of global block (start-K+i)
                # (oldest first), frequency bins sharded over the time axis
                "zfdl": jnp.zeros(
                    (K, 2, c_global, self._bins_pad), jnp.float32
                ),
            }
            self.carry_spec = {"zfdl": P(None, None, CH_AXIS, TIME_AXIS)}
            self.params = {"ir_f": self.transform_ir(self._ir)}
            # reversed G planes, bin-sharded with the carry: shared
            # (2, K+1, binsP); per-channel (C, 2, K+1, binsP)
            self.param_spec = {
                "ir_f": P(None, None, TIME_AXIS)
                if self._ir.ndim == 1
                else P(CH_AXIS, None, None, TIME_AXIS)
            }
        else:
            F = 1 << int(np.ceil(np.log2(Pn + n_local)))
            self._F = F
            self.carry = {"hist": jnp.zeros((c_global, Pn), jnp.float32)}
            self.carry_spec = {"hist": P(CH_AXIS, None)}
            self.params = {"ir_f": self.transform_ir(self._ir)}
            # shared: (2, bins) replicated; per-channel: (C, 2, bins)
            self.param_spec = {
                "ir_f": P() if self._ir.ndim == 1 else P(CH_AXIS, None, None)
            }
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def transform_ir(self, ir) -> jnp.ndarray:
        """Spectra planes for the built FFT layout (also used by live IR
        swaps — same length, same partitioning)."""
        ir = np.asarray(ir, np.float64)
        if not getattr(self, "_partitioned", False):
            spec = np.fft.rfft(ir, n=self._F, axis=-1)
            # re/im planes, not complex64: the layout of pipe_tpu.ops.ols
            planes = np.stack([spec.real, spec.imag], axis=-2).astype(np.float32)
            return jnp.asarray(planes)
        B, K = self._F // 2, self._K
        bins = B + 1
        shared = ir.ndim == 1
        irc = ir[None, :] if shared else ir
        C = irc.shape[0]
        padded = np.zeros((C, K * B), np.float64)
        padded[:, : irc.shape[1]] = irc
        parts = padded.reshape(C, K, B)
        H = np.fft.rfft(parts, n=self._F, axis=-1)  # (C, K, bins)
        # fold the window halo into the partitions (class docstring):
        # G_m = sigma * H_m + H_{m-1}, sigma_k = (-1)^k
        sigma = np.where(np.arange(bins) % 2 == 0, 1.0, -1.0)
        G = np.zeros((C, K + 1, bins), np.complex128)
        G[:, :K] += sigma * H
        G[:, 1:] += H
        Grev = G[:, ::-1]  # Grev[k] = G_{K-k}: the windowed-MAC order
        planes = np.stack(
            [Grev.real, Grev.imag], axis=1
        ).astype(np.float32)  # (C, 2, K+1, bins)
        pad = self._bins_pad - bins
        if pad:
            planes = np.pad(planes, ((0, 0), (0, 0), (0, 0), (0, pad)))
        if shared:
            return jnp.asarray(planes[0])  # (2, K+1, binsP)
        return jnp.asarray(planes)  # (C, 2, K+1, binsP)

    def apply(self, carry, params, x):
        if self._partitioned:
            return self._apply_fdl(carry, params, x)
        C, N = x.shape
        Pn = carry["hist"].shape[1]
        left = halo_from_left(x, Pn, TIME_AXIS, carry["hist"])
        w = jnp.concatenate([left, x], axis=1)  # (C, Pn+N)
        W = jnp.fft.rfft(w, n=self._F, axis=-1)
        Wr, Wi = jnp.real(W), jnp.imag(W)
        ir_f = params["ir_f"]
        if ir_f.ndim == 2:  # shared (2, bins)
            hr, hi = ir_f[0][None, :], ir_f[1][None, :]
        else:  # per-channel (C_local, 2, bins)
            hr, hi = ir_f[:, 0, :], ir_f[:, 1, :]
        Y = jax.lax.complex(Wr * hr - Wi * hi, Wr * hi + Wi * hr)
        y = jnp.fft.irfft(Y, n=self._F, axis=-1)
        y = y[:, Pn : Pn + N].astype(jnp.float32)
        new_hist = last_shard(x[:, -Pn:], TIME_AXIS)
        return {"hist": new_hist}, y

    def _apply_fdl(self, carry, params, x):
        """Distributed UPOLS step (class docstring). Local shapes: ``x``
        (C, B); ``carry['zfdl']`` (K, 2, C, bs); ``params['ir_f']``
        (2, K+1, bs) shared or (C, 2, K+1, bs) per-channel."""
        C, B = x.shape
        K, T = self._K, self._t
        bins = B + 1
        bs = self._bs
        # zero-padded block FFT — each device transforms only its own block
        A = jnp.fft.rfft(x, n=self._F, axis=-1)  # (C, bins)
        Ap = jnp.stack([jnp.real(A), jnp.imag(A)]).astype(jnp.float32)
        Ap = jnp.pad(Ap, ((0, 0), (0, 0), (0, self._bins_pad - bins)))
        if T > 1:
            # transpose #1: blocks-over-devices -> bins-over-devices
            new = lax.all_to_all(
                Ap.reshape(2, C, T, bs), TIME_AXIS,
                split_axis=2, concat_axis=0, tiled=False,
            )  # (T, 2, C, bs): block g's spectrum, my bin slice
        else:
            new = Ap[None]
        # ext[i] = A-spectrum of global block (start - K + i), oldest first
        ext = jnp.concatenate([carry["zfdl"], new], axis=0)  # (K+T, 2, C, bs)
        # windows[g, k] = A of block (start + g - K + k); Y_g needs k=0..K
        w = jnp.stack([ext[g : g + K + 1] for g in range(T)])
        wr, wi = w[:, :, 0], w[:, :, 1]  # (T, K+1, C, bs)
        hi_p = config.matmul_precision()
        ir_f = params["ir_f"]  # Grev: Grev[k] = G_{K-k} matches windows
        if ir_f.ndim == 3:  # shared (2, K+1, bs)
            gr, gi = ir_f[0], ir_f[1]
            Yr = jnp.einsum("gkcb,kb->gcb", wr, gr, precision=hi_p) - jnp.einsum(
                "gkcb,kb->gcb", wi, gi, precision=hi_p
            )
            Yi = jnp.einsum("gkcb,kb->gcb", wr, gi, precision=hi_p) + jnp.einsum(
                "gkcb,kb->gcb", wi, gr, precision=hi_p
            )
        else:  # per-channel (C, 2, K+1, bs)
            gr, gi = ir_f[:, 0], ir_f[:, 1]
            Yr = jnp.einsum("gkcb,ckb->gcb", wr, gr, precision=hi_p) - jnp.einsum(
                "gkcb,ckb->gcb", wi, gi, precision=hi_p
            )
            Yi = jnp.einsum("gkcb,ckb->gcb", wr, gi, precision=hi_p) + jnp.einsum(
                "gkcb,ckb->gcb", wi, gr, precision=hi_p
            )
        Yp = jnp.stack([Yr, Yi], axis=1)  # (T, 2, C, bs)
        if T > 1:
            # transpose #2: each output block's spectrum back to its owner
            back = lax.all_to_all(
                Yp, TIME_AXIS, split_axis=0, concat_axis=2, tiled=False
            )  # (2, C, T, bs), bin slices in order
            Y = back.reshape(2, C, self._bins_pad)[:, :, :bins]
        else:
            Y = Yp[0][:, :, :bins]
        y = jnp.fft.irfft(lax.complex(Y[0], Y[1]), n=self._F, axis=-1)
        y = y[:, B:].astype(jnp.float32)
        return {"zfdl": ext[T:]}, y


def _sharded_iir(v, s, a1, a2, basis):
    """Pole recurrence ``y[n] = v[n] - a1 y[n-1] - a2 y[n-2]`` over a
    time-sharded chunk, built from the streaming engine's tiled Toeplitz
    kernel (``ops.biquad._iir_apply``) instead of a materialized
    (N, C, 2, 2) associative scan:

      1. zero-entering-state local response ``y0`` — the hot pass, through
         whichever engine ``_iir_apply`` picks for the local chunk;
      2. ``basis = (alpha, beta)`` — length-N responses to unit entering
         states, one (2, N) pass through the same kernel (shared between
         the main and the refinement call, so passed in);
      3. per-device affine totals (transition matrix from the basis tails,
         forcing from the ``y0`` tails) exclusive-prefix-combined across
         the time axis to recover each device's true entering state;
      4. rank-2 boundary correction ``y = y0 + s0_1*alpha + s0_2*beta``.
    """
    from pipe_tpu.ops.biquad import _iir_apply

    C, N = v.shape
    alpha, beta = basis[0], basis[1]  # (N,), (N,)
    y0 = _iir_apply(v, jnp.zeros((C, 2), jnp.float32), a1, a2)

    # transition of (y[-1], y[-2]) over one local chunk, channel-independent
    A_N = jnp.stack(
        [jnp.stack([alpha[N - 1], beta[N - 1]]),
         jnp.stack([alpha[N - 2], beta[N - 2]])]
    )  # (2, 2)
    u_N = jnp.stack([y0[:, N - 1], y0[:, N - 2]], axis=1)  # (C, 2)
    unit = (
        jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (C, 2, 2)),
        jnp.zeros((C, 2), jnp.float32),
    )
    pre = exclusive_prefix(
        TIME_AXIS, _affine_combine, unit,
        (jnp.broadcast_to(A_N[None], (C, 2, 2)), u_N),
    )
    hi = lax.Precision.HIGHEST
    s0 = jnp.einsum("cij,cj->ci", pre[0], s, precision=hi) + pre[1]
    return y0 + s0[:, 0:1] * alpha[None, :] + s0[:, 1:2] * beta[None, :]


class OLSGainStage(OLSStage):
    """Overlap-save convolution with a folded gain (sharded twin of
    ``ops.fused.OLSWithGain``): the traced gain scales the stage output —
    exact, since convolution is linear."""

    def __init__(self, ir, gain=1.0):
        super().__init__(ir)
        self._gain = jnp.asarray(gain, jnp.float32)

    def build(self, c_global, c_local, n_local):
        if self._gain.ndim == 1:
            self._gain = self.pad_channels(self._gain, c_global, "gain")
        super().build(c_global, c_local, n_local)
        self.params["gain"] = self._gain
        self.param_spec["gain"] = (
            P() if self._gain.ndim == 0 else P(CH_AXIS)
        )

    def apply(self, carry, params, x):
        carry, y = super().apply(carry, params, x)
        g = params["gain"]
        if g.ndim == 1:
            g = g[:, None]
        return carry, y * g


class BiquadStage(Stage):
    """One biquad section, time-sharded on the streaming engine's tiled
    Toeplitz kernel (see :func:`_sharded_iir`), with one iterative-
    refinement pass on the pole recurrence (``ops.biquad._iir_refine``
    mechanics, here crossing the device boundary like the main pass) to
    clear 100 dB on high-Q poles. ``refine=False`` skips the second pass.

    ``precision='extended'`` runs the double-f32 engine instead
    (``ops.biquad`` dd layer): the local prefix scan, the cross-device
    exclusive prefix of per-device affine totals, and the chunk carry all
    ride as f32 hi/lo pairs — near-DC sections whose f32 noise-gain floor
    sits below 100 dB (docs/PERF_NOTES.md 'kappa floor') stay >=100 dB on
    the mesh exactly as on the streaming engine."""

    def __init__(self, sos_row, refine: bool = True,
                 precision: str | None = None):
        from pipe_tpu.ops.biquad import split_f32_pair

        sos = np.asarray(sos_row, np.float64).reshape(-1)
        if sos.shape[0] != 6:
            raise ValueError("BiquadStage takes one SOS row")
        if precision not in (None, "extended"):
            raise ValueError("precision must be None or 'extended'")
        pair = split_f32_pair(sos / sos[3])
        self._sos = jnp.asarray(pair[0])
        self._sos_lo = jnp.asarray(pair[1])
        self._refine = bool(refine)
        self._extended = precision == "extended"

    def build(self, c_global, c_local, n_local):
        self.carry = {
            "x_tail": jnp.zeros((c_global, 2), jnp.float32),
            "s": jnp.zeros((c_global, 2), jnp.float32),
        }
        self.carry_spec = {"x_tail": P(CH_AXIS, None), "s": P(CH_AXIS, None)}
        self.params = {"sos": self._sos, "sos_lo": self._sos_lo}
        self.param_spec = {"sos": P(), "sos_lo": P()}
        if self._extended:
            self.carry["s_lo"] = jnp.zeros((c_global, 2), jnp.float32)
            self.carry_spec["s_lo"] = P(CH_AXIS, None)
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def apply(self, carry, params, x):
        if self._extended:
            return self._apply_extended(carry, params, x)
        return self._apply_f32(carry, params, x)

    def _apply_extended(self, carry, params, x):
        """Double-f32 sharded recurrence: local dd prefix scan, dd affine
        exclusive prefix across the time axis, dd chunk carry."""
        from pipe_tpu.ops.biquad import (
            _dd_add, _dd_affine_combine, _dd_apply_boundary, _dd_forcing,
            _dd_identity_elem, _dd_mul, _iir_scan_dd, _opaque_one,
        )

        C, N = x.shape
        coefs, coefs_lo = params["sos"], params["sos_lo"]
        a1 = (coefs[4], coefs_lo[4])
        a2 = (coefs[5], coefs_lo[5])
        one = _opaque_one(coefs[0])
        x_tail = halo_from_left(x, 2, TIME_AXIS, carry["x_tail"])
        buf = jnp.concatenate([x_tail, x], axis=1)
        v = _dd_forcing(buf, coefs, coefs_lo)
        pref = _iir_scan_dd(v, a1, a2, one)
        # per-device affine total = the prefix at the last local sample
        totals = jax.tree.map(lambda t: t[:, -1], pref)
        pre = exclusive_prefix(
            TIME_AXIS,
            lambda l, r: _dd_affine_combine(l, r, one),
            _dd_identity_elem((C,)),
            totals,
        )
        # entering state for this device: A_pre @ s_carry + u_pre, in dd
        s_lo = carry.get("s_lo", jnp.zeros_like(carry["s"]))
        sx = (carry["s"][:, 0], s_lo[:, 0])
        sy = (carry["s"][:, 1], s_lo[:, 1])
        pa, pb, pc, pd, pux, puy = pre
        devx = _dd_add(
            _dd_add(_dd_mul(pa, sx, one), _dd_mul(pb, sy, one)), pux
        )
        devy = _dd_add(
            _dd_add(_dd_mul(pc, sx, one), _dd_mul(pd, sy, one)), puy
        )
        s_dev = (
            jnp.stack([devx[0], devy[0]], axis=1),
            jnp.stack([devx[1], devy[1]], axis=1),
        )
        yh, yl = _dd_apply_boundary(pref, s_dev, one)
        new_s = last_shard(
            jnp.stack([yh[:, -1], yh[:, -2]], axis=1), TIME_AXIS
        )
        new_s_lo = last_shard(
            jnp.stack([yl[:, -1], yl[:, -2]], axis=1), TIME_AXIS
        )
        new_x_tail = last_shard(x[:, -2:], TIME_AXIS)
        return {
            "x_tail": new_x_tail, "s": new_s, "s_lo": new_s_lo
        }, yh

    def _apply_f32(self, carry, params, x):
        from pipe_tpu.ops.biquad import _iir_apply

        C, N = x.shape
        coefs = params["sos"]
        b0, b1, b2, a1, a2 = coefs[0], coefs[1], coefs[2], coefs[4], coefs[5]

        x_tail = halo_from_left(x, 2, TIME_AXIS, carry["x_tail"])
        buf = jnp.concatenate([x_tail, x], axis=1)
        v = b0 * buf[:, 2:] + b1 * buf[:, 1:-1] + b2 * buf[:, :-2]

        # unit-state boundary responses, shared by both passes
        basis = _iir_apply(
            jnp.zeros((2, N), jnp.float32), jnp.eye(2, dtype=jnp.float32),
            a1, a2,
        )
        y = _sharded_iir(v, carry["s"], a1, a2, basis)
        if self._refine:
            # f32 defect of the recurrence, with the previous two outputs
            # crossing the device boundary as a halo; the filtered defect
            # is itself a (zero-state) recurrence across the whole chunk
            y_prev = halo_from_left(y, 2, TIME_AXIS, carry["s"][:, ::-1])
            ybuf = jnp.concatenate([y_prev, y], axis=1)
            r = v - (y + a1 * ybuf[:, 1:-1] + a2 * ybuf[:, :-2])
            y = y + _sharded_iir(
                r, jnp.zeros((C, 2), jnp.float32), a1, a2, basis
            )

        new_s = last_shard(
            jnp.stack([y[:, -1], y[:, -2]], axis=1), TIME_AXIS
        )
        new_x_tail = last_shard(x[:, -2:], TIME_AXIS)
        return {"x_tail": new_x_tail, "s": new_s}, y


def _sharded_envelope(carry_env, carry_lo, xa, release_coef, attack_oma):
    """Smoothed peak envelope over a time-sharded chunk: the (associative)
    max-decay release follower and one-pole attack smoother of
    ``pipe_tpu.ops.dynamics`` run as local scans, then extend across devices
    via an exclusive prefix of the per-device scan totals — exactly the
    biquad mechanic. The attack smoother gets the same refinement pass as
    the streaming engine (``ops.dynamics.envelope_block``): the residual —
    with the dd coefficient complement and the dd state low word — is
    filtered as a second zero-entering cross-device recurrence, so the
    sharded envelope holds the streaming engine's measured floor (flat
    105-108 dB vs float64 oracles at any attack time, docs/PERF_NOTES.md).
    Returns ``(new_env (C,2), new_lo (C,), env (C,N))``."""
    from pipe_tpu.ops.biquad import _opaque_one, _two_prod, _two_sum
    from pipe_tpu.ops.dynamics import _max_decay_combine, _affine1_combine

    C, N = xa.shape
    # 1) local max-decay scan, zero-seeded
    r = jnp.broadcast_to(release_coef, xa.shape)
    decay_cum, raw_loc = lax.associative_scan(
        _max_decay_combine, (r, xa), axis=1
    )
    # 2) entering value via cross-device exclusive prefix of totals
    pre_a, pre_m = exclusive_prefix(
        TIME_AXIS, _max_decay_combine,
        (jnp.ones((C,), jnp.float32), jnp.zeros((C,), jnp.float32)),
        (decay_cum[:, -1], raw_loc[:, -1]),
    )
    enter_raw = jnp.maximum(pre_m, carry_env[:, 0] * pre_a)
    # 3) correction: raw[n] = max(raw_loc[n], enter_raw * r^(n+1))
    raw = jnp.maximum(raw_loc, enter_raw[:, None] * decay_cum)

    # 4) attack smoother on corrected raw, same two-step structure
    one = _opaque_one(attack_oma)
    oma = attack_oma
    # laundered dd coefficient split (see ops.dynamics.envelope_block: a
    # plain two_sum(1.0, -oma) loses its error channel under jit)
    ca_hi = (1.0 - oma) * one
    ca_lo = ((1.0 - ca_hi) * one - oma) * one
    e0 = carry_env[:, 1]
    cab = jnp.broadcast_to(ca_hi, xa.shape)
    # um is the rounded forcing (oma*raw)*one; ue its exact error term,
    # reused by the refinement residual
    um, ue = _two_prod(jnp.broadcast_to(oma, xa.shape), raw, one)

    def chunk_recurrence(v, enter):
        """y[n] = ca_hi y[n-1] + v[n] across the whole chunk, entering
        value ``enter`` (C,) at the chunk start."""
        cum, loc = lax.associative_scan(_affine1_combine, (cab, v), axis=1)
        pca, pu = exclusive_prefix(
            TIME_AXIS, _affine1_combine,
            (jnp.ones((C,), jnp.float32), jnp.zeros((C,), jnp.float32)),
            (cum[:, -1], loc[:, -1]),
        )
        return loc + (pca * enter + pu)[:, None] * cum

    y = chunk_recurrence(um, e0)

    # 5) refinement: accurate residual (previous output crosses the device
    # boundary as a one-sample halo), filtered as a second zero-entering
    # chunk recurrence
    yprev = jnp.concatenate(
        [halo_from_left(y, 1, TIME_AXIS, e0[:, None]), y[:, :-1]], axis=1
    )
    p, pe = _two_prod(cab, yprev, one)
    s, se = _two_sum(p, um)
    res = (s - y) + (pe + se + ue) + ca_lo * yprev
    # the carried dd low word enters at the GLOBAL first sample only
    g0 = lax.axis_index(TIME_AXIS) == 0
    res = res.at[:, 0].add(jnp.where(g0, ca_hi * carry_lo, 0.0))
    dy = chunk_recurrence(res, jnp.zeros((C,), jnp.float32))
    env = (y + dy) * one

    eh, el = _two_sum(y[:, -1], dy[:, -1])
    new_env = last_shard(jnp.stack([raw[:, -1], eh], axis=1), TIME_AXIS)
    new_lo = last_shard(el, TIME_AXIS)
    return new_env, new_lo, env


class CompressorStage(Stage):
    """Peak compressor, time-sharded via :func:`_sharded_envelope`."""

    def __init__(self, threshold_db=-18.0, ratio=4.0, attack_ms=5.0,
                 release_ms=120.0, makeup_db=0.0, sample_rate=44100.0):
        self._p = dict(
            threshold_db=threshold_db, ratio=ratio, attack_ms=attack_ms,
            release_ms=release_ms, makeup_db=makeup_db,
        )
        self.sample_rate = float(sample_rate)

    def build(self, c_global, c_local, n_local):
        self.carry = {
            "env": jnp.zeros((c_global, 2), jnp.float32),
            "env_lo": jnp.zeros((c_global,), jnp.float32),
        }
        self.params = {
            k: jnp.asarray(v, jnp.float32) for k, v in self._p.items()
        }
        self.carry_spec = {"env": P(CH_AXIS, None), "env_lo": P(CH_AXIS)}
        self.param_spec = {k: P() for k in self._p}
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        from pipe_tpu.ops.dynamics import (
            _attack_oma, _decay_coef, compressor_gain,
        )

        rc = _decay_coef(params["release_ms"], self.sample_rate)
        ao = _attack_oma(params["attack_ms"], self.sample_rate)
        new_env, new_lo, env = _sharded_envelope(
            carry["env"], carry["env_lo"], jnp.abs(x), rc, ao
        )
        g = compressor_gain(
            env, params["threshold_db"], params["ratio"], params["makeup_db"]
        )
        return {"env": new_env, "env_lo": new_lo}, x * g


class LimiterStage(CompressorStage):
    """Peak limiter: a compressor with an infinite ratio (gain above the
    threshold is fully cancelled after the attack window)."""

    def __init__(self, threshold_db=-1.0, attack_ms=0.5, release_ms=50.0,
                 makeup_db=0.0, sample_rate=44100.0):
        super().__init__(
            threshold_db=threshold_db, ratio=float("inf"),
            attack_ms=attack_ms, release_ms=release_ms,
            makeup_db=makeup_db, sample_rate=sample_rate,
        )


class GateStage(Stage):
    """Downward-expander noise gate (``pipe_tpu.ops.dynamics.NoiseGate``),
    time-sharded: same envelope machinery as the compressor, hard gain
    split at the threshold."""

    def __init__(self, threshold_db=-50.0, range_db=80.0, attack_ms=1.0,
                 release_ms=200.0, sample_rate=44100.0):
        self._p = dict(
            threshold_db=threshold_db, range_db=range_db,
            attack_ms=attack_ms, release_ms=release_ms,
        )
        self.sample_rate = float(sample_rate)

    def build(self, c_global, c_local, n_local):
        self.carry = {
            "env": jnp.zeros((c_global, 2), jnp.float32),
            "env_lo": jnp.zeros((c_global,), jnp.float32),
        }
        self.params = {
            k: jnp.asarray(v, jnp.float32) for k, v in self._p.items()
        }
        self.carry_spec = {"env": P(CH_AXIS, None), "env_lo": P(CH_AXIS)}
        self.param_spec = {k: P() for k in self._p}
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        from pipe_tpu.ops.dynamics import _attack_oma, _decay_coef

        rc = _decay_coef(params["release_ms"], self.sample_rate)
        ao = _attack_oma(params["attack_ms"], self.sample_rate)
        new_env, new_lo, env = _sharded_envelope(
            carry["env"], carry["env_lo"], jnp.abs(x), rc, ao
        )
        env_db = 20.0 * jnp.log10(jnp.maximum(env, 1e-8))
        atten = jnp.power(10.0, -params["range_db"] / 20.0)
        g = jnp.where(env_db >= params["threshold_db"], 1.0, atten)
        return {"env": new_env, "env_lo": new_lo}, x * g


def _pow_int_traced(base, e):
    """``base ** e`` for TRACED integer exponents ``e >= 0``, correct for
    negative bases (the traced twin of ``ops.dynamics._pow_int``)."""
    mag = jnp.abs(base) ** e.astype(jnp.float32)
    sgn = jnp.where(
        base < 0, 1.0 - 2.0 * (e % 2).astype(jnp.float32), 1.0
    )
    return mag * sgn


class DelayStage(Stage):
    """Pure delay / feedback echo, time-sharded, for ANY ``delay_frames``.

    The delay-line state is a TIME-SHARDED BLOCK RING (r4, VERDICT r3
    item 2): each device carries its OWN last ``kc = ceil(D/N)`` local
    blocks of the delayed stream (``N`` = global chunk frames), so carry
    memory is O(C*D/T) per device and the carry update is a local roll —
    zero collectives. (The r3 design replicated a (C, D) history on every
    device, all_gather'ed the FULL chunk to refresh it when D > n_local,
    and ppermuted two whole blocks for the multi-hop tap — the 3.05x/6.0x
    traffic outliers in docs/PERF_NOTES.md.) The tap
    ``d[i] = s[global_i - D]`` is one n-wide window of the virtual block
    stream, split over at most two source blocks ``h = ceil(D/n)`` and
    ``h-1`` hops to the left: two cyclic ``ppermute``s move EXACTLY the
    needed (n-r)- and r-sample slices (``r = h*n - D``), each source
    selecting the ring slot its destination's chunk-back distance asks
    for — payload ratio ~1.0 chunk-size-independent.

    Four regimes:

    - **pure delay** (no feedback requested, ``D < N``): ring of the
      input stream x; ``set_feedback`` on the wrapper raises (structural
      capability, as in the streaming component).
    - **feedback free** (``D >= N``): the tap reads only PREVIOUS chunks,
      so the recurrence ``s[n] = x[n] + fb*s[n-D]`` never crosses devices
      within a chunk — the ring stores s and feedback is structurally
      free (mirroring the streaming ring at ``D >= block_size``);
      ``feedback`` is a live traced parameter.
    - **feedback echo with** ``D <= n_local`` (ladder): the recurrence
      crosses device boundaries; the D-history transfer across one
      m-sample segment is an affine map with a rotated index — lane j
      gets gain ``fb^{(m+j)//D}`` and rotation ``m % D``, both CLOSED
      FORMS in m — so only the (C, D) offset vectors ride the
      cross-device exclusive-prefix ppermute ladder (the r3 ladder also
      shipped the (D,) gain vector and the rotation per hop). Traffic
      ``(log2 T + 2) * D/n_local`` <= ~4x.
    - **feedback echo with** ``n_local < D < N`` (wave-DAG, r5): the
      dependency distance D makes positions ``[w*D, (w+1)*D)`` a wave
      depending only on the wave before it, so the whole chunk evaluates
      in ``W = ceil(N/D)`` ELEMENTWISE passes, each fetching its D-back
      window with the pure tap's two exact-slice cyclic ppermutes (the
      CURRENT s in the send buffer). Traffic ``W * ~1.0x`` payload vs
      the ladder's ``4*D/n_local`` (11.2x at D=0.7N; measured shootout
      in ``benchmarks/delay_wave_dag.py``), and the evaluation order is
      exactly the sequential recurrence — no affine powers, so the
      precision is the streaming engine's. See docs/PERF_NOTES.md
      "Delay traffic".
    """

    def __init__(self, delay_frames: int, feedback: float = 0.0,
                 wet: float = 1.0, dry: float = 0.0,
                 allow_feedback: Optional[bool] = None):
        if delay_frames < 1:
            raise ValueError("delay_frames must be >= 1")
        if allow_feedback is False and feedback != 0.0:
            raise ValueError(
                "contradictory arguments: nonzero feedback with "
                "allow_feedback=False (the pure-delay path would silently "
                "ignore the feedback)"
            )
        self.delay_frames = int(delay_frames)
        self._init = dict(feedback=feedback, wet=wet, dry=dry)
        self._allow_feedback = allow_feedback

    def build(self, c_global, c_local, n_local):
        D = self.delay_frames
        T = max(1, int(self.time_shards))
        N = n_local * T  # global chunk frames
        self._n, self._T, self._N = n_local, T, N
        # D >= N makes feedback structurally free (the tap only reads
        # previous chunks), mirroring the streaming ring at D >= block
        self.can_feedback = (
            D >= N
            or self._init["feedback"] != 0.0
            or bool(self._allow_feedback)
        )
        # Feedback regimes by D vs the sharding (r5 wave-DAG adoption,
        # VERDICT r4 item 7 — measured in benchmarks/delay_wave_dag.py):
        #   D <= n_local : offsets-only affine prefix LADDER
        #                  (traffic (log2 T + 2) * D/n_local <= ~4x)
        #   n_local < D < N : WAVE-DAG — ceil(N/D) elementwise waves of
        #                  exact-slice ring fetches (traffic W * 1.0x,
        #                  vs the ladder's 4*D/n_local which reaches
        #                  ~15x as D -> N); bitwise the sequential
        #                  evaluation order, so precision is exact
        #   D >= N       : structurally free (ring of s, zero extra)
        self._wave = self.can_feedback and n_local < D < N
        self._ladder = self.can_feedback and D <= n_local
        self.params = {
            k: jnp.asarray(v, jnp.float32) for k, v in self._init.items()
        }
        self.param_spec = {k: P() for k in self._init}
        if self._ladder:
            # D <= n_local: the replicated history is bounded by the chunk
            self.carry = {"hist": jnp.zeros((c_global, D), jnp.float32)}
            self.carry_spec = {"hist": P(CH_AXIS, None)}
        else:
            kc = -(-D // N)
            self._kc = kc
            # block ring: device g's columns hold ITS OWN blocks from
            # chunk-back kc..1 (oldest first) — carry memory /T
            self.carry = {"ring": jnp.zeros((c_global, kc * N), jnp.float32)}
            self.carry_spec = {"ring": P(CH_AXIS, TIME_AXIS)}
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    # -- block-ring tap: exact-slice cyclic fetch ------------------------

    def _fetch(self, buf, k, lo, hi):
        """Columns ``[lo, hi)`` of virtual stream block ``g - k`` (``g``
        = this device's time index; block ``-m`` = the stream's m-th
        block back, owned by device ``(g-k) mod T`` at chunk-back
        ``ceil((k - dst)/T)``). ``buf`` is the shared send buffer
        ``[zeros | ring | current]`` (zeros resolve reads past the ring
        depth — stream prehistory; the current slot is zeros on the
        D >= N feedback ring, where it is provably never selected). Each
        device ships only the [lo, hi) window its single cyclic
        destination needs."""
        n, T, kc = self._n, self._T, self._kc
        C = buf.shape[0]
        w = hi - lo
        if w <= 0:
            return jnp.zeros((C, 0), buf.dtype)
        g = lax.axis_index(TIME_AXIS)
        dst = (g + k) % T
        # chunk-backs my destination needs (0 = its current chunk)
        q = jnp.maximum((k - dst + T - 1) // T, 0)
        # send-buffer slots: [zeros | back-kc .. back-1 | current];
        # back-q lives at slot kc+1-q, clamped onto the zero slot for
        # prehistory
        slot = jnp.clip(kc + 1 - q, 0, kc + 1)
        send = lax.dynamic_slice(buf, (0, slot * n + lo), (C, w))
        hops = k % T
        if hops == 0:
            return send  # own ring slot: no communication
        return lax.ppermute(
            send, TIME_AXIS, perm=[(i, (i + hops) % T) for i in range(T)]
        )

    def apply(self, carry, params, x):
        from pipe_tpu.ops.dynamics import _affine1_combine

        C, n = x.shape
        D = self.delay_frames
        if not self._ladder:
            ring = carry["ring"]  # (C, kc*n) own previous blocks
            h = -(-D // n)
            r = h * n - D  # 0 <= r < n: window offset in block g-h
            if self._wave:
                # WAVE-DAG feedback for n_local < D < N (r5): positions
                # [w*D, (w+1)*D) form wave w — each depends only on the
                # wave before it (s[p-D] is w-1's final value) or, for
                # wave 0, on the previous chunk's ring. Each wave is ONE
                # elementwise fma over a freshly fetched D-back window
                # (the same two exact-slice cyclic ppermutes as the pure
                # tap, with the CURRENT s in the send buffer), masked to
                # its own positions. ceil(N/D) waves move W * ~1.0x
                # payload where the ladder moved 4*D/n_local (11x at
                # D=0.7N — benchmarks/delay_wave_dag.py), and the
                # evaluation order is exactly the sequential recurrence.
                fb = params["feedback"]
                W = -(-self._N // D)
                g = lax.axis_index(TIME_AXIS)
                p = g * n + jnp.arange(n, dtype=jnp.int32)  # global pos
                s = x
                delayed = jnp.zeros_like(x)
                for w in range(W):
                    buf = jnp.concatenate(
                        [jnp.zeros_like(x), ring, s], axis=1
                    )
                    dfull = jnp.concatenate(
                        [self._fetch(buf, h, r, n),
                         self._fetch(buf, h - 1, 0, r)],
                        axis=1,
                    )
                    mask = ((p >= w * D) & (p < (w + 1) * D))[None, :]
                    s = jnp.where(mask, x + fb * dfull, s)
                    delayed = jnp.where(mask, dfull, delayed)
                y = params["dry"] * x + params["wet"] * delayed
                return {"ring": jnp.concatenate([ring[:, n:], s], axis=1)}, y
            # tap window [g*n - D, g*n - D + n) = block(g-h)[r:] ++
            # block(g-h+1)[:r]; for D >= N both pieces predate this
            # chunk, so the ring may store s and feedback is free (the
            # current slot is then never selected — pass zeros)
            xcur = jnp.zeros_like(x) if self.can_feedback else x
            buf = jnp.concatenate(
                [jnp.zeros_like(x), ring, xcur], axis=1
            )
            delayed = jnp.concatenate(
                [self._fetch(buf, h, r, n), self._fetch(buf, h - 1, 0, r)],
                axis=1,
            )
            s = x + params["feedback"] * delayed if self.can_feedback else x
            y = params["dry"] * x + params["wet"] * delayed
            return {"ring": jnp.concatenate([ring[:, n:], s], axis=1)}, y

        hist = carry["hist"]  # (C, D): trailing D samples of s
        fb = params["feedback"]
        # 1) locally-driven response s0 (zero entering history): lane-
        # parallel scan over left-padded rows of D (pad lanes are zero, so
        # they do not perturb the real positions)
        w = (-n) % D
        m = (n + w) // D
        rows = jnp.pad(x, ((0, 0), (w, 0))).reshape(C, m, D)
        a = jnp.broadcast_to(fb, rows.shape)
        _, s0_rows = lax.associative_scan(_affine1_combine, (a, rows), axis=1)
        s0 = s0_rows.reshape(C, m * D)[:, w:]

        # 2) per-device history transfer h_out[j] = fb^e_j h_in[(j+n)%D] + b_j
        # with e_j = (n+j)//D: the closed form of the lane-touch count
        # over an n-sample segment (0 for untouched lanes)
        from pipe_tpu.ops.dynamics import _pow_int as pow_int

        j = np.arange(D)
        p = n - D + j  # position feeding lane j (negative = untouched)
        touched = jnp.asarray(p >= 0)
        a_dev = pow_int(fb, (n + j) // D)  # (D,); fb^0 = 1 on untouched
        b_dev = jnp.where(
            touched[None, :], s0[:, np.clip(p, 0, None)], 0.0
        )  # (C, D)

        # cross-device entering history via an OFFSETS-ONLY exclusive-
        # prefix ladder: the gain/rotation of any m-sample segment has
        # the closed form (fb^{(m+j)//D}, m % D), so devices derive them
        # locally from the traced segment length and only the (C, D)
        # offsets ride the ppermute ladder (the r3 ladder also shipped
        # the (D,) gains and the rotation per hop).
        jD = jnp.arange(D, dtype=jnp.int32)

        def seg_map(m):
            """(gains, rotation) of the composed transfer over a traced
            m-sample segment."""
            return _pow_int_traced(fb, (m + jD) // D), m % D

        T = lax.axis_size(TIME_AXIS)
        idx = lax.axis_index(TIME_AXIS)
        if T == 1:
            pre_b = jnp.zeros_like(b_dev)
        else:

            def shift_right(v, hops):
                return lax.ppermute(
                    v, TIME_AXIS,
                    perm=[(i, i + hops) for i in range(T - hops)],
                )

            # Hillis-Steele over seeds: acc_d covers segment
            # [max(0, d-k), d) before the step-k round, so the combine's
            # later-segment map is seg_map(min(d, k) * n)
            acc = jnp.where(idx == 0, 0.0, shift_right(b_dev, 1))
            k = 1
            while k < T:
                recv = shift_right(acc, k)
                a_acc, r_acc = seg_map(jnp.minimum(idx, k) * n)
                comb = a_acc[None, :] * jnp.roll(recv, -r_acc, axis=1) + acc
                acc = jnp.where(idx >= k, comb, acc)
                k *= 2
            pre_b = acc
        # entering history for this device
        pre_a, pre_r = seg_map(idx * n)
        h_in = pre_a[None, :] * jnp.roll(hist, -pre_r, axis=1) + pre_b

        # 3) boundary correction: s[i] = s0[i] + fb^{i//D + 1} h_in[i % D]
        i = np.arange(n)
        s = s0 + pow_int(fb, i // D + 1)[None, :] * h_in[:, i % D]

        # 4) delayed tap needs no exchange: history for the first D lanes,
        # the local stream after that
        if D >= n:
            delayed = h_in[:, :n]
        else:
            delayed = jnp.concatenate([h_in, s[:, :-D]], axis=1)
        y = params["dry"] * x + params["wet"] * delayed

        # 5) carry: every device applies its OWN transfer to its h_in; the
        # last device's result is the global exit history
        h_out = a_dev[None, :] * jnp.roll(h_in, -(n % D), axis=1) + b_dev
        return {"hist": broadcast_last(h_out, TIME_AXIS)}, y


class ChannelizerStage(Stage):
    """Polyphase DFT filterbank analysis bank, time-sharded: the branch-FIR
    history is a ``K*(S-1)``-sample input halo (the FIR tail mechanic);
    each device channelizes its aligned local window independently. Output
    is ``C * 2 * (K//2+1)`` stacked re/im channels at rate ``sr/K``
    (``pipe_tpu.ops.channelizer`` layout)."""

    def __init__(self, num_channels: int, taps_per_branch: int = 16):
        from pipe_tpu.ops.channelizer import (
            design_prototype, polyphase_branches,
        )

        if num_channels < 2 or num_channels % 2:
            raise ValueError("num_channels must be even and >= 2")
        self.K = int(num_channels)
        self._gp = jnp.asarray(
            polyphase_branches(
                design_prototype(num_channels, taps_per_branch), num_channels
            ),
            jnp.float32,
        )

    def build(self, c_global, c_local, n_local):
        K = self.K
        S = int(self._gp.shape[1])
        H = K * (S - 1)
        if n_local % K:
            raise ShapeConstraintError(
                f"local chunk {n_local} must be a multiple of K={K}"
            )
        if H > n_local:
            raise ShapeConstraintError(
                f"channelizer halo {H} exceeds local chunk {n_local}"
            )
        self._H = H
        bins = K // 2 + 1
        self.carry = {"hist": jnp.zeros((c_global, H), jnp.float32)}
        self.params = {"gp": self._gp}
        self.carry_spec = {"hist": P(CH_AXIS, None)}
        self.param_spec = {"gp": P()}
        self.out_c_global = c_global * 2 * bins
        self.out_c_local = c_local * 2 * bins
        # C-major output layout: pad channels land at trailing rows
        self.out_c_user = self.user_channels(c_global) * 2 * bins
        self.out_n_local = n_local // K

    def apply(self, carry, params, x):
        from pipe_tpu.ops.channelizer import channelize_block

        C, N = x.shape
        K = self.K
        bins = K // 2 + 1
        left = halo_from_left(x, self._H, TIME_AXIS, carry["hist"])
        re, im = channelize_block(left, x, params["gp"], K)
        out = jnp.stack([re, im], axis=2).reshape(C * bins * 2, N // K)
        new_hist = last_shard(x[:, -self._H:], TIME_AXIS)
        return {"hist": new_hist}, out.astype(jnp.float32)


class IQMixStage(Stage):
    """Quadrature downconverter, time+channel sharded: exact integer-phase
    oscillator offset by each device's global sample position. Output is
    ``(2*C, N)`` with each channel shard locally ordered [I..., Q...]
    (``pipe_tpu.ops.demod.IQMix``; under channel sharding the I/Q pairing
    is per-shard, which downstream detector stages split locally)."""

    channel_pad_safe = False  # positional I/Q rail layout

    def __init__(self, freq_hz: float, sample_rate: float = 44100.0):
        from pipe_tpu.ops.demod import _rationalize

        self.freq_hz = float(freq_hz)
        self.num, self.den = _rationalize(freq_hz, sample_rate, 1 << 14)

    def build(self, c_global, c_local, n_local):
        self.carry = {"n": jnp.asarray(0, jnp.int32)}
        self.params = {}
        self.carry_spec = {"n": P()}
        self.param_spec = {}
        self._n_local = n_local
        self.out_c_global = 2 * c_global
        self.out_c_local = 2 * c_local
        self.out_n_local = n_local

    def apply(self, carry, params, x):
        from pipe_tpu.ops.demod import osc_block

        C, N = x.shape
        # device-local phase start: chunk start + my global offset
        n0 = (carry["n"] + lax.axis_index(TIME_AXIS) * self._n_local) % self.den
        c, s, _ = osc_block(n0, self.num, self.den, N)
        i = x * c[None, :]
        q = x * (-s[None, :])
        new_n = (carry["n"] + lax.axis_size(TIME_AXIS) * self._n_local) % self.den
        return {"n": new_n}, jnp.concatenate([i, q], axis=0)


class EnvelopeDetectorStage(Stage):
    """Magnitude over local I/Q pairs: ``(2C, N) -> (C, N)`` (AM detector,
    ``pipe_tpu.ops.demod.EnvelopeDetector``). Stateless."""

    channel_pad_safe = False

    def build(self, c_global, c_local, n_local):
        if c_local % 2:
            raise ValueError("EnvelopeDetectorStage expects paired I/Q rails")
        self.carry = ()
        self.params = {}
        self.carry_spec = ()
        self.param_spec = {}
        self.out_c_global = c_global // 2
        self.out_c_local = c_local // 2
        self.out_n_local = n_local

    def apply(self, carry, params, x):
        half = x.shape[0] // 2
        i, q = x[:half], x[half:]
        return (), jnp.sqrt(i * i + q * q)


class FMDiscriminatorStage(Stage):
    """Quadrature FM discriminator over local I/Q pairs:
    ``(2C, N) -> (C, N)`` of instantaneous frequency in cycles/sample
    (``pipe_tpu.ops.demod.FMDiscriminator``). The previous I/Q sample is a
    one-sample halo from the left neighbor."""

    channel_pad_safe = False

    def build(self, c_global, c_local, n_local):
        if c_local % 2:
            raise ValueError("FMDiscriminatorStage expects paired I/Q rails")
        self.carry = {"prev": jnp.zeros((c_global, 1), jnp.float32)}
        self.params = {}
        self.carry_spec = {"prev": P(CH_AXIS, None)}
        self.param_spec = {}
        self.out_c_global = c_global // 2
        self.out_c_local = c_local // 2
        self.out_n_local = n_local

    def apply(self, carry, params, x):
        C, N = x.shape
        half = C // 2
        prev = halo_from_left(x, 1, TIME_AXIS, carry["prev"])  # (2C, 1)
        buf = jnp.concatenate([prev, x], axis=1)  # (2C, 1+N)
        i, q = x[:half], x[half:]
        ip, qp = buf[:half, :N], buf[half:, :N]
        re = ip * i + qp * q
        im = ip * q - qp * i
        f = jnp.arctan2(im, re) / (2.0 * np.pi)
        new_prev = last_shard(x[:, -1:], TIME_AXIS)
        return {"prev": new_prev}, f.astype(jnp.float32)


class _SpectralStageBase(Stage):
    """Streaming STFT -> per-bin transform -> weighted-OLA, time-sharded.

    Two halos per chunk step, both one hop to the right: the analysis history
    (each device frames its windows against the left neighbor's trailing
    ``W - hop`` samples, exactly the FIR tail mechanic) and the synthesis
    spill (the overlap-add contribution of each device's last windows lands
    up to ``W - hop`` samples past its right edge, so it is ``ppermute``d to
    the right neighbor and added at its output start). Device (t-1)'s spill
    becomes the next chunk's carried OLA tail. Per-window transforms are
    memoryless, so sharded output matches the sequential stream exactly
    (same windows at the same global hop alignment).
    """

    def __init__(self, window_size: int, hop: int):
        from pipe_tpu.ops.spectral import design_stft_window

        self.window_size = int(window_size)
        self.hop = int(hop)
        wa, ws = design_stft_window(self.window_size, self.hop)
        self._wa, self._ws = jnp.asarray(wa), jnp.asarray(ws)

    @property
    def bins(self) -> int:
        return self.window_size // 2 + 1

    def _spectral_params(self):
        raise NotImplementedError

    def _spectral_param_specs(self):
        raise NotImplementedError

    def _transform(self, re, im, params):
        raise NotImplementedError

    def build(self, c_global, c_local, n_local):
        L = self.window_size - self.hop
        if n_local % self.hop != 0:
            raise ShapeConstraintError(
                f"local chunk {n_local} must be a multiple of hop {self.hop}"
            )
        if L > n_local:
            raise ShapeConstraintError(
                f"STFT halo {L} exceeds local chunk {n_local}; "
                "use a larger chunk or fewer time shards"
            )
        self.carry = {
            "hist": jnp.zeros((c_global, L), jnp.float32),
            "tail": jnp.zeros((c_global, L), jnp.float32),
        }
        self.params = self._spectral_params()
        self.carry_spec = {
            "hist": P(CH_AXIS, None),
            "tail": P(CH_AXIS, None),
        }
        self.param_spec = self._spectral_param_specs()
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        from pipe_tpu.ops.spectral import _ola_fold, frame_hops

        C, N = x.shape
        W, H = self.window_size, self.hop
        L = W - H
        left = halo_from_left(x, L, TIME_AXIS, carry["hist"])
        ext = jnp.concatenate([left, x], axis=1)  # [history, chunk]
        F = N // H
        wins = frame_hops(ext, W, H, F) * self._wa
        spec = jnp.fft.rfft(wins, axis=-1)
        re = jnp.real(spec).astype(jnp.float32)
        im = jnp.imag(spec).astype(jnp.float32)
        re, im = self._transform(re, im, params)
        out = (
            jnp.fft.irfft(lax.complex(re, im), n=W, axis=-1).astype(jnp.float32)
            * self._ws
        )
        acc = _ola_fold(out, H)  # (C, N + L)
        spill = acc[:, N:]  # lands on the right neighbor
        incoming = halo_from_left(spill, L, TIME_AXIS, carry["tail"])
        y = acc[:, :N].at[:, :L].add(incoming)
        new_hist = last_shard(x[:, -L:], TIME_AXIS)
        new_tail = last_shard(spill, TIME_AXIS)
        return {"hist": new_hist, "tail": new_tail}, y


class SpectralGainStage(_SpectralStageBase):
    """Per-bin gain curve in the STFT domain, time+channel sharded. ``gains``
    is ``(bins,)`` shared (replicated) or ``(C, bins)`` per-channel (sharded
    over CH_AXIS); live-retunable between chunks."""

    def __init__(self, window_size: int, hop: int, gains=None):
        super().__init__(window_size, hop)
        if gains is None:
            gains = np.ones(self.bins, np.float32)
        g = jnp.asarray(gains, jnp.float32)
        if g.ndim not in (1, 2) or g.shape[-1] != self.bins:
            raise ValueError(
                f"gains must be (bins,) or (C, bins) with bins={self.bins}"
            )
        self._gains = g

    def build(self, c_global, c_local, n_local):
        if self._gains.ndim == 2:
            self._gains = self.pad_channels(self._gains, c_global, "gains")
        super().build(c_global, c_local, n_local)

    def _spectral_params(self):
        return {"gains": self._gains}

    def _spectral_param_specs(self):
        return {"gains": P() if self._gains.ndim == 1 else P(CH_AXIS, None)}

    def _transform(self, re, im, params):
        g = params["gains"]
        g = g[None, None, :] if g.ndim == 1 else g[:, None, :]
        return re * g, im * g


class SpectralGateStage(_SpectralStageBase):
    """Per-bin noise gate (soft-knee downward expander) in the STFT domain,
    time+channel sharded. Threshold/reduction are live parameters."""

    def __init__(self, window_size: int, hop: int, threshold: float,
                 reduction_db: float = -80.0, knee_db: float = 6.0):
        super().__init__(window_size, hop)
        self._threshold = float(threshold)
        self._reduction_db = float(reduction_db)
        self.knee_db = max(float(knee_db), 1e-3)

    def _spectral_params(self):
        return {
            "threshold": jnp.float32(self._threshold),
            "reduction_db": jnp.float32(self._reduction_db),
        }

    def _spectral_param_specs(self):
        return {"threshold": P(), "reduction_db": P()}

    def _transform(self, re, im, params):
        mag = jnp.sqrt(re * re + im * im) + 1e-30
        over_db = 20.0 * jnp.log10(mag / params["threshold"])
        frac = jnp.clip(over_db / self.knee_db + 0.5, 0.0, 1.0)
        floor = 10.0 ** (params["reduction_db"] / 20.0)
        gain = floor + (1.0 - floor) * frac
        return re * gain, im * gain


class MixStage(Stage):
    """Matrix mix with channel reduction over the mesh: ``psum`` of the
    column-sharded partial products — the on-device merged mixer sink.
    Output is replicated over the channel axis; must be the last stage."""

    def __init__(self, matrix):
        self._m = jnp.asarray(matrix, jnp.float32)
        if self._m.ndim != 2:
            raise ValueError("mix matrix must be (C_out, C_in)")

    def build(self, c_global, c_local, n_local):
        c_user = self.user_channels(c_global)
        if self._m.shape[1] != c_user:
            raise ValueError(
                f"mix matrix expects {self._m.shape[1]} input channels, "
                f"chain has {c_user}"
            )
        if self._m.shape[1] != c_global:
            self._m = jnp.concatenate(
                [
                    self._m,
                    jnp.zeros(
                        (self._m.shape[0], c_global - self._m.shape[1]),
                        self._m.dtype,
                    ),
                ],
                axis=1,
            )
        self.carry = ()
        self.params = {"m": self._m}
        self.carry_spec = ()
        # columns sharded with the input channels
        self.param_spec = {"m": P(None, CH_AXIS)}
        # output channels are global and replicated over the ch axis
        self.out_c_global = self.out_c_local = self._m.shape[0]
        self.out_c_user = self._m.shape[0]
        self.out_n_local = n_local
        self.reduces_channels = True

    def apply(self, carry, params, x):
        partial_mix = jnp.dot(
            params["m"], x, preferred_element_type=jnp.float32,
            precision=config.matmul_precision(),
        )
        return (), lax.psum(partial_mix, CH_AXIS)


class FIRGainStage(FIRStage):
    """FIR with a folded gain (the sharded twin of
    ``ops.fused.FIRWithGain``): the effective bank ``taps * gain`` is
    rebuilt inside the step from the traced params, so both retunes stay
    recompile-free and the gain costs T mults instead of an N-sample
    elementwise pass."""

    def __init__(self, taps, gain=1.0):
        super().__init__(taps)
        self._gain = jnp.asarray(gain, jnp.float32)

    def build(self, c_global, c_local, n_local):
        if self._gain.ndim == 1:
            self._gain = self.pad_channels(self._gain, c_global, "gain")
        super().build(c_global, c_local, n_local)
        self.params["gain"] = self._gain
        self.param_spec["gain"] = P() if self._gain.ndim == 0 else P(CH_AXIS)

    def apply(self, carry, params, x):
        from pipe_tpu.ops.fused import scaled_taps

        hc = scaled_taps(params["taps"], params["gain"])
        return super().apply(carry, {"taps": hc}, x)


class MixGainStage(MixStage):
    """Mix with a folded gain (sharded twin of ``ops.fused.MixWithGain``):
    ``side='in'`` scales columns (upstream gain), ``side='out'`` rows."""

    def __init__(self, matrix, gain=1.0, side: str = "in"):
        if side not in ("in", "out"):
            raise ValueError("side must be 'in' or 'out'")
        super().__init__(matrix)
        self._gain = jnp.asarray(gain, jnp.float32)
        if self._gain.ndim == 1:
            want = self._m.shape[1] if side == "in" else self._m.shape[0]
            if self._gain.shape[0] != want:
                raise ValueError(
                    f"per-channel gain of length {self._gain.shape[0]} "
                    f"cannot fold into the "
                    f"{'columns' if side == 'in' else 'rows'} of a "
                    f"{tuple(self._m.shape)} matrix (needs {want})"
                )
        self.side = side

    def build(self, c_global, c_local, n_local):
        super().build(c_global, c_local, n_local)
        self.params["gain"] = self._gain
        # an 'in'-side vector gain shards with the matrix columns; an
        # 'out'-side one is replicated like the output channels
        if self._gain.ndim == 0:
            self.param_spec["gain"] = P()
        else:
            self.param_spec["gain"] = (
                P(CH_AXIS) if self.side == "in" else P()
            )

    def apply(self, carry, params, x):
        from pipe_tpu.ops.fused import scaled_matrix

        m = scaled_matrix(params["m"], params["gain"], self.side)
        return super().apply(carry, {"m": m}, x)


class BiquadCascadeStage(Stage):
    """A run of biquad sections as ONE sharded stage (the sharded twin of
    ``ops.fused.BiquadCascade``): stacked SOS rows applied in sequence
    inside a single stage, one carry pytree, per-row live retunes."""

    def __init__(self, sos, refine: bool = True, precision: str | None = None):
        from pipe_tpu.ops.biquad import split_f32_pair

        sos = np.asarray(sos, np.float64)
        if sos.ndim == 1:
            sos = sos[None, :]
        if sos.shape[-1] != 6:
            raise ValueError("sos rows must be [b0 b1 b2 a0 a1 a2]")
        if precision not in (None, "extended"):
            raise ValueError("precision must be None or 'extended'")
        pair = split_f32_pair(sos / sos[:, 3:4])
        self._sos = jnp.asarray(pair[0])
        self._sos_lo = jnp.asarray(pair[1])
        self._row = BiquadStage(
            np.array([1.0, 0, 0, 1.0, 0, 0]), refine=refine,
            precision=precision,
        )
        self._extended = precision == "extended"

    @property
    def n_sections(self) -> int:
        return int(self._sos.shape[0])

    def build(self, c_global, c_local, n_local):
        S = self._sos.shape[0]
        z = lambda: jnp.zeros((S, c_global, 2), jnp.float32)
        self.carry = {"x_tail": z(), "s": z()}
        self.carry_spec = {
            "x_tail": P(None, CH_AXIS, None), "s": P(None, CH_AXIS, None),
        }
        if self._extended:
            self.carry["s_lo"] = z()
            self.carry_spec["s_lo"] = P(None, CH_AXIS, None)
        self.params = {"sos": self._sos, "sos_lo": self._sos_lo}
        self.param_spec = {"sos": P(), "sos_lo": P()}
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        S = self._sos.shape[0]
        new = {k: [] for k in carry}
        for i in range(S):
            rc = {k: carry[k][i] for k in carry}
            rp = {"sos": params["sos"][i], "sos_lo": params["sos_lo"][i]}
            nc, x = self._row.apply(rc, rp, x)
            for k in new:
                new[k].append(nc[k])
        return {k: jnp.stack(v) for k, v in new.items()}, x


class ShardedChain:
    """Compose stages into one shard_map'ed, jitted chunk step with carried
    stream state.

    Args:
      mesh: a ``(ch, time)`` mesh from :func:`pipe_tpu.parallel.make_mesh`.
      stages: stage list; :class:`MixStage` may only appear last.
      channels: global channel count (ANY count — non-divisible counts are
        zero-padded to the ch-axis multiple internally and sliced off the
        output; r4, VERDICT r3 item 3).
      chunk_frames: global frames per step (divisible by the time-axis size).
    """

    def __init__(self, mesh, stages: Sequence[Stage], channels: int, chunk_frames: int):
        self.mesh = mesh
        self.stages = list(stages)
        self.channels = channels
        self.chunk_frames = chunk_frames

        ch_shards = mesh.shape[CH_AXIS]
        t_shards = mesh.shape[TIME_AXIS]
        if chunk_frames % t_shards:
            raise ValueError(
                f"chunk_frames {chunk_frames} not divisible by {t_shards}"
            )
        c_user = channels
        c_global = -(-channels // ch_shards) * ch_shards  # padded
        self._c_pad_in = c_global
        c_local = c_global // ch_shards
        n_local = chunk_frames // t_shards
        if not self.stages:
            raise ValueError("ShardedChain needs at least one stage")
        for i, st in enumerate(self.stages):
            if c_user != c_global and not st.channel_pad_safe:
                raise ValueError(
                    f"{type(st).__name__} has a positional channel layout "
                    f"and needs channels divisible by the mesh channel "
                    f"axis ({ch_shards}); got {c_user}"
                )
            st.time_shards = t_shards
            st.c_user = c_user if c_user != c_global else None
            st.out_c_user = None
            st.build(c_global, c_local, n_local)
            if st.out_c_user is None:
                # channel-preserving stages keep the user count; channel-
                # changing stages either set out_c_user in build or are
                # pad-unsafe (c_user == c_global here)
                st.out_c_user = (
                    c_user if st.out_c_global == c_global
                    else st.out_c_global
                )
            c_user = st.out_c_user
            c_global, c_local, n_local = (
                st.out_c_global, st.out_c_local, st.out_n_local
            )
        final_reduces = any(
            getattr(st, "reduces_channels", False) for st in self.stages
        )
        if final_reduces and not getattr(self.stages[-1], "reduces_channels", False):
            raise ValueError("MixStage must be the last stage")
        self.out_channels = c_user
        self.out_frames = n_local * t_shards

        carry_specs = tuple(st.carry_spec for st in self.stages)
        param_specs = tuple(st.param_spec for st in self.stages)
        x_spec = P(CH_AXIS, TIME_AXIS)
        final_reduces = bool(
            self.stages and getattr(self.stages[-1], "reduces_channels", False)
        )
        y_spec = P(None, TIME_AXIS) if final_reduces else P(CH_AXIS, TIME_AXIS)

        stages_ref = self.stages

        def chunk_fn(carries, params, x):
            new_carries = []
            for st, c, p in zip(stages_ref, carries, params):
                c2, x = st.apply(c, p, x)
                new_carries.append(c2)
            return tuple(new_carries), x

        self._step = jax.jit(
            shard_map(
                chunk_fn,
                mesh=mesh,
                in_specs=(carry_specs, param_specs, x_spec),
                out_specs=(carry_specs, y_spec),
                check_vma=False,
            ),
            # the old carries are dead after each step: donate their buffers
            donate_argnums=(0,),
        )
        # place the initial carries with their run-time sharding so the very
        # first step's donation can alias them (a freshly-created unsharded
        # array cannot back a sharded output buffer)
        from jax.sharding import NamedSharding

        def _place(carry, spec_tree):
            leaves, treedef = jax.tree.flatten(carry)
            specs = treedef.flatten_up_to(spec_tree)
            placed = [
                jax.device_put(l, NamedSharding(mesh, s))
                for l, s in zip(leaves, specs)
            ]
            return jax.tree.unflatten(treedef, placed)

        self.carries = tuple(
            _place(st.carry, st.carry_spec) for st in self.stages
        )

    def params(self):
        return tuple(st.params for st in self.stages)

    def step(self, x):
        """One chunk: ``x`` (channels, chunk_frames) -> (out_channels,
        out_frames), advancing carried state. Non-divisible channel counts
        ride zero pad rows internally, sliced off here."""
        if x.shape[0] != self._c_pad_in:
            x = jnp.concatenate(
                [
                    jnp.asarray(x, jnp.float32),
                    jnp.zeros(
                        (self._c_pad_in - x.shape[0], x.shape[1]),
                        jnp.float32,
                    ),
                ],
                axis=0,
            )
        new_carries, y = self._step(self.carries, self.params(), x)
        self.carries = new_carries
        return y[: self.out_channels]

    def process(self, x) -> np.ndarray:
        """Stream a long (channels, N) signal chunk by chunk (N divisible by
        chunk_frames) and return the concatenated output."""
        C, N = x.shape
        if N % self.chunk_frames:
            raise ValueError(f"N={N} not divisible by chunk {self.chunk_frames}")
        outs = []
        for i in range(N // self.chunk_frames):
            xc = jnp.asarray(
                x[:, i * self.chunk_frames : (i + 1) * self.chunk_frames],
                jnp.float32,
            )
            outs.append(np.asarray(self.step(xc)))
        return np.concatenate(outs, axis=1)
