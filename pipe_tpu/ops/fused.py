"""Fused FIR -> polyphase-resample stage (graph-level operator fusion).

A FIR filter followed by an L/M polyphase resampler is mathematically one
polyphase bank: with ``h`` the FIR taps and ``hp[p]`` the resampler's
phase-``p`` subfilter, the combined bank is the per-phase convolution

    hc[p] = conv(hp[p], h)            (K_c = K + T - 1 taps per phase)

because resampling commutes the input-rate FIR into the upsampled-rate
prototype: ``H(z^L) * Hrs(z)`` decomposes phase-wise to exactly this.
Validated to 2.2e-15 max error against the sequential float64 oracle
(docs/PERF_NOTES.md).

Fusing removes one device-memory round trip of the intermediate signal
and collapses two graph stages into one, at the cost of a wider bank
(K_c = K + T - 1 taps per phase). Its speed on the GPU is not measured
yet.

The combination happens INSIDE jit from the traced tap vector and bank, so
``set_taps`` / ``set_bank`` mutations remain retrace-free, preserving the
framework's mutation-without-recompile guarantee (SURVEY.md §2 C2/C3
mapping).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal, SignalProperties
from pipe_tpu.ops.resample import _reduce_ratio, polyphase_design

from pipe_tpu import config


def combine_bank(taps, hp):
    """Combined polyphase bank ``hc[p] = conv(hp[p], taps)``.

    Args:
      taps: ``(T,)`` traced FIR taps (shared across channels).
      hp: ``(L, K)`` traced polyphase bank.

    Returns ``(L, K + T - 1)``. Pure traced ops — safe to call inside jit
    with live (mutated) values.
    """
    T = taps.shape[-1]
    out = lax.conv_general_dilated(
        hp[:, None, :],
        jnp.flip(taps)[None, None, :],
        window_strides=(1,),
        padding=((T - 1, T - 1),),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=config.matmul_precision(),
    )
    return out[:, 0, :]  # (L, K + T - 1)


class FIRResampler:
    """Fused FIR + L/M resampler processor.

    Drop-in for ``Processors(FIR(taps).processor(), Resampler(up, down)
    .processor())`` with identical output (to f32 rounding) and one fewer
    stage. Both the FIR taps and the resampler bank stay live parameters.
    """

    def __init__(self, taps, up: int, down: int, taps_per_phase: int = 32):
        self._taps = jnp.asarray(taps, jnp.float32)
        if self._taps.ndim != 1:
            raise ValueError("FIRResampler uses shared (T,) taps")
        if up <= 0 or down <= 0:
            raise ValueError("up/down must be positive")
        self.up, self.down = _reduce_ratio(up, down)
        self.taps_per_phase = taps_per_phase
        self._hp = jnp.asarray(
            polyphase_design(self.up, self.down, taps_per_phase), jnp.float32
        )
        self._component = None
        self.context = None

    def processor(self):
        from pipe_tpu.ops.resample import Resampler

        L, M = self.up, self.down
        T = self._taps.shape[0]
        Kc = self.taps_per_phase + T - 1

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C = props.channels
            # reuse the Resampler's streaming step machinery with the
            # combined bank; the bank is rebuilt inside jit each block from
            # the live taps/hp params (cheap: (L, K) x (T,) conv)
            inner = Resampler.__new__(Resampler)
            inner.up, inner.down = L, M
            inner.taps_per_phase = Kc
            inner._hp = combine_bank(self._taps, self._hp)
            inner._component = None
            inner.context = None
            inner_alloc = inner.processor()
            comp = inner_alloc(mctx, block_size, props)

            # swap the step to recombine from live taps each block
            base_step = comp.step

            def step(state, params, sig: Signal):
                hc = combine_bank(params["taps"], params["hp_base"])
                return base_step(state, {"hp": hc}, sig)

            self._component = Processor(
                output=comp.output,
                step=step,
                state=comp.state,
                params={"taps": self._taps, "hp_base": self._hp},
                start=comp.start,
                flush=comp.flush,
                out_capacity=comp.out_capacity,
            )
            return self._component

        return alloc

    def set_taps(self, taps):
        """Mutate the FIR taps (same length); retrace-free."""
        t = jnp.asarray(taps, jnp.float32)

        def fn():
            self._component.set_param("taps", t)

        return self.context.mutate(fn)

    def set_bank(self, hp):
        """Mutate the resampler prototype bank (same shape); retrace-free."""
        b = jnp.asarray(hp, jnp.float32)

        def fn():
            self._component.set_param("hp_base", b)

        return self.context.mutate(fn)


def fused_apply(hist, x, taps, hp, up: int, down: int):
    """Functional fused full-block path for chunk runners: ``hist`` is
    ``(C, K+T-2)`` input history; returns ``(C, B*up//down)``."""
    from pipe_tpu.ops.resample import resample_apply

    hc = combine_bank(taps, hp)
    return resample_apply(hist, x, hc, up, down)


def scaled_taps(taps, gain):
    """Gain folded into FIR taps: scalar gain scales the shared taps
    (T mults instead of N per block); a per-channel gain broadcasts shared
    taps to a per-channel bank. Exact — per-channel convolution commutes
    with per-channel scaling."""
    g = jnp.asarray(gain)
    if g.ndim == 0:
        return taps * g
    if taps.ndim == 1:
        return g[:, None] * taps[None, :]
    return g[:, None] * taps


def scaled_matrix(matrix, gain, side: str):
    """Gain folded into a mix matrix: upstream gain scales COLUMNS
    (``M @ diag(g)``), downstream gain scales ROWS (``diag(g) @ M``)."""
    g = jnp.asarray(gain)
    if g.ndim == 0:
        return matrix * g
    return matrix * (g[None, :] if side == "in" else g[:, None])


class FIRWithGain:
    """FIR with a folded gain (``optimize.fuse`` rewrite of an adjacent
    Gain + FIR pair, either order — they commute per channel). Both the
    taps and the gain stay live parameters; the effective bank is rebuilt
    inside jit from the traced values, so retunes never recompile."""

    def __init__(self, taps, gain=1.0):
        self._taps = jnp.asarray(taps, jnp.float32)
        self._gain = jnp.asarray(gain, jnp.float32)
        self._component = None
        self.context = None

    def processor(self):
        from pipe_tpu.ops.fir import fir_block, fir_init_tail

        def alloc(mctx, block_size, props: SignalProperties):
            taps = self._taps
            if taps.ndim == 2 and taps.shape[0] != props.channels:
                raise ValueError(
                    f"per-channel taps for {taps.shape[0]} channels, "
                    f"line has {props.channels}"
                )
            if (
                self._gain.ndim == 1
                and self._gain.shape[0] != props.channels
            ):
                raise ValueError(
                    f"per-channel gain of length {self._gain.shape[0]} "
                    f"cannot fold into a {props.channels}-channel FIR"
                )
            self.context = mctx
            T = taps.shape[-1]

            def step(state, params, sig: Signal):
                hc = scaled_taps(params["taps"], params["gain"])
                new_tail, y = fir_block(
                    state["tail"], sig.data, sig.frames, hc
                )
                return {"tail": new_tail}, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state={"tail": fir_init_tail(props.channels, T)},
                params={"taps": taps, "gain": self._gain},
            )
            return self._component

        return alloc

    def set_taps(self, taps):
        t = jnp.asarray(taps, jnp.float32)

        def fn():
            self._component.set_param("taps", t)

        return self.context.mutate(fn)

    def set_gain(self, gain):
        g = jnp.asarray(gain, jnp.float32)

        def fn():
            self._component.set_param("gain", g)

        return self.context.mutate(fn)


class MixWithGain:
    """Matrix mixer with a folded gain (``optimize.fuse`` rewrite of an
    adjacent Gain + ChannelMix pair): ``side='in'`` folds an upstream gain
    into the matrix columns, ``side='out'`` a downstream gain into the
    rows. Matrix and gain stay independent live parameters."""

    def __init__(self, matrix, gain=1.0, side: str = "in"):
        if side not in ("in", "out"):
            raise ValueError("side must be 'in' or 'out'")
        self._m = jnp.asarray(matrix, jnp.float32)
        self._gain = jnp.asarray(gain, jnp.float32)
        if self._gain.ndim == 1:
            want = self._m.shape[1] if side == "in" else self._m.shape[0]
            if self._gain.shape[0] != want:
                raise ValueError(
                    f"per-channel gain of length {self._gain.shape[0]} "
                    f"cannot fold into the {'columns' if side == 'in' else 'rows'} "
                    f"of a {tuple(self._m.shape)} matrix (needs {want})"
                )
        self.side = side
        self._component = None
        self.context = None

    def processor(self):
        from pipe_tpu.ops.mix import channel_mix_block

        out_channels, in_channels = self._m.shape
        side = self.side

        def alloc(mctx, block_size, props: SignalProperties):
            if props.channels != in_channels:
                raise ValueError(
                    f"mix matrix expects {in_channels} input channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx

            def step(state, params, sig: Signal):
                m = scaled_matrix(params["matrix"], params["gain"], side)
                return state, Signal(
                    channel_mix_block(sig.data, m), sig.frames
                )

            self._component = Processor(
                output=SignalProperties(
                    sample_rate=props.sample_rate, channels=out_channels
                ),
                step=step,
                state={},
                params={"matrix": self._m, "gain": self._gain},
            )
            return self._component

        return alloc

    def set_matrix(self, matrix):
        m = jnp.asarray(matrix, jnp.float32)

        def fn():
            self._component.set_param("matrix", m)

        return self.context.mutate(fn)

    def set_gain(self, gain):
        g = jnp.asarray(gain, jnp.float32)

        def fn():
            self._component.set_param("gain", g)

        return self.context.mutate(fn)


class BiquadCascade:
    """A run of adjacent Biquad processors collapsed into ONE cascade
    component (``optimize.fuse`` rewrite): one ``biquad_block`` call over
    the stacked SOS rows instead of a separate component per filter. Each
    original ``Biquad`` object keeps mutating its own rows through
    :meth:`set_part_sos` (installed as its delegate)."""

    def __init__(self, parts):
        """``parts``: the original ``ops.Biquad`` objects, in line order.
        They must agree on ``refine`` and ``precision`` (checked by the
        fuse rule)."""
        from pipe_tpu.ops.biquad import split_f32_pair

        self._parts = list(parts)
        self._rows = {}  # id(part) -> (start, count)
        sos64 = []
        start = 0
        for part in self._parts:
            n = part.n_sections
            self._rows[id(part)] = (start, n)
            sos64.append(part._sos64)
            start += n
        combined = np.vstack(sos64)
        pair = split_f32_pair(combined)
        self._sos = jnp.asarray(pair[0])
        self._sos_lo = jnp.asarray(pair[1])
        self._refine = self._parts[0]._refine
        self._extended = self._parts[0]._extended
        self._component = None
        self.context = None

    def processor(self):
        from pipe_tpu.ops.biquad import biquad_block, biquad_init_state

        refine, extended = self._refine, self._extended
        S = self._sos.shape[0]

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx

            def step(state, params, sig: Signal):
                new_state, y = biquad_block(
                    state, sig.data, sig.frames, params["sos"],
                    refine=refine,
                    sections_lo=params["sos_lo"] if extended else None,
                )
                return new_state, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state=biquad_init_state(props.channels, S, extended=extended),
                params={"sos": self._sos, "sos_lo": self._sos_lo},
            )
            return self._component

        return alloc

    def set_part_sos(self, part, sos):
        """Mutation updating only ``part``'s rows of the combined SOS
        (the delegate target for a fused-away ``Biquad.set_sos``)."""
        from pipe_tpu.ops.biquad import Biquad, split_f32_pair

        start, count = self._rows[id(part)]
        sos64 = Biquad._normalize(sos)
        if sos64.shape[0] != count:
            raise ValueError(
                f"fused biquad expects {count} section(s) for this part, "
                f"got {sos64.shape[0]}"
            )
        pair = split_f32_pair(sos64)
        hi = jnp.asarray(pair[0])
        lo = jnp.asarray(pair[1])

        def fn():
            cur = self._component.get_param("sos")
            cur_lo = self._component.get_param("sos_lo")
            self._component.set_param(
                "sos", cur.at[start : start + count].set(hi)
            )
            self._component.set_param(
                "sos_lo", cur_lo.at[start : start + count].set(lo)
            )

        return self.context.mutate(fn)

def cascade_taps(parts):
    """Combined impulse response of a run of FIRs: full convolution of the
    taps along the last axis (per-channel (C, T) rows broadcast against
    shared (T,) vectors). Pure traced ops — safe inside jit with live
    (mutated) values."""
    import jax

    eff = parts[0]
    for t in parts[1:]:
        if eff.ndim == 1 and t.ndim == 1:
            eff = jnp.convolve(eff, t)
        else:
            C = eff.shape[0] if eff.ndim == 2 else t.shape[0]
            a = jnp.broadcast_to(eff, (C, eff.shape[-1]))
            b = jnp.broadcast_to(t, (C, t.shape[-1]))
            eff = jax.vmap(jnp.convolve)(a, b)
    return eff


class _CascadeHandle:
    """Per-member delegate for a fused-away FIR: routes ``set_taps`` to
    the owning cascade's slot."""

    def __init__(self, cascade, part):
        self._cascade = cascade
        self._part = part

    def set_taps(self, taps):
        return self._cascade.set_part_taps(self._part, taps)


class FIRCascade:
    """A run of adjacent FIR processors collapsed into ONE component
    (``optimize.fuse`` rewrite): the combined impulse response
    ``conv(t_0, ..., t_{n-1})`` is rebuilt inside jit from the traced
    member taps, so each original ``FIR`` keeps retuning its own slot
    retrace-free. Exact: convolution is associative, and the single
    combined pass replaces n-1 intermediate HBM round trips."""

    def __init__(self, parts):
        self._parts = list(parts)
        self._taps = [jnp.asarray(p._init_taps, jnp.float32) for p in parts]
        self._slot = {id(p): i for i, p in enumerate(parts)}
        self._component = None
        self.context = None

    def processor(self):
        from pipe_tpu.ops.fir import fir_block, fir_init_tail

        def alloc(mctx, block_size, props: SignalProperties):
            for t in self._taps:
                if t.ndim == 2 and t.shape[0] != props.channels:
                    raise ValueError(
                        f"per-channel taps for {t.shape[0]} channels, "
                        f"line has {props.channels}"
                    )
            self.context = mctx
            T_comb = sum(t.shape[-1] for t in self._taps) - (
                len(self._taps) - 1
            )
            n = len(self._taps)

            def step(state, params, sig: Signal):
                hc = cascade_taps([params[f"taps{i}"] for i in range(n)])
                new_tail, y = fir_block(
                    state["tail"], sig.data, sig.frames, hc
                )
                return {"tail": new_tail}, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state={"tail": fir_init_tail(props.channels, T_comb)},
                params={f"taps{i}": t for i, t in enumerate(self._taps)},
            )
            return self._component

        return alloc

    def set_part_taps(self, part, taps):
        """Mutation updating only ``part``'s slot of the cascade (the
        delegate target for a fused-away ``FIR.set_taps``)."""
        i = self._slot[id(part)]
        t = jnp.asarray(taps, jnp.float32)
        if t.shape != tuple(self._taps[i].shape):
            raise ValueError(
                f"taps shape {t.shape} != allocated "
                f"{tuple(self._taps[i].shape)}: live retunes must keep "
                "shapes"
            )

        def fn():
            self._taps[i] = t  # restarts/re-allocations keep the retune
            self._component.set_param(f"taps{i}", t)

        return self.context.mutate(fn)

    def handle_for(self, part):
        return _CascadeHandle(self, part)


class OLSWithGain:
    """Overlap-save convolution with a folded gain (``optimize.fuse``
    rewrite of an adjacent Gain + OLSConvolve pair, either order — they
    commute per channel since convolution is linear). The gain stays a
    live traced parameter applied to the stage output; XLA fuses the
    multiply into the irfft consumer, so the fold's win is one fewer
    graph component."""

    def __init__(self, ir, gain=1.0):
        self._ir = np.asarray(ir)
        self._gain = jnp.asarray(gain, jnp.float32)
        self._component = None
        self.context = None

    def processor(self):
        from pipe_tpu.ops.ols import ols_block, ols_init_state, partition_ir

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            spec = jnp.asarray(partition_ir(self._ir, block_size))
            if spec.ndim == 4 and spec.shape[2] != props.channels:
                raise ValueError(
                    f"per-channel IR for {spec.shape[2]} channels, "
                    f"line has {props.channels}"
                )
            if (
                self._gain.ndim == 1
                and self._gain.shape[0] != props.channels
            ):
                raise ValueError(
                    f"per-channel gain of length {self._gain.shape[0]} "
                    f"cannot fold into a {props.channels}-channel line"
                )
            n_parts = spec.shape[1]

            def step(state, params, sig: Signal):
                new_state, y = ols_block(
                    state, sig.data, sig.frames, params["ir_spec"]
                )
                g = params["gain"]
                if g.ndim == 1:
                    g = g[:, None]
                return new_state, sig.with_data(y * g)

            self._component = Processor(
                output=props,
                step=step,
                state=ols_init_state(props.channels, block_size, n_parts),
                params={"ir_spec": spec, "gain": self._gain},
            )
            return self._component

        return alloc

    def set_ir(self, ir):
        from pipe_tpu.ops.ols import partition_ir

        def fn():
            block_size = self._component.state["prev"].shape[1]
            self._component.set_param(
                "ir_spec",
                jnp.asarray(partition_ir(np.asarray(ir), block_size)),
            )

        return self.context.mutate(fn)

    def set_gain(self, gain):
        g = jnp.asarray(gain, jnp.float32)

        def fn():
            self._component.set_param("gain", g)

        return self.context.mutate(fn)
