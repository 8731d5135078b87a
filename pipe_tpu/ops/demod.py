"""Oscillators, mixing, and demodulation.

Phase tracking uses exact integer arithmetic: the oscillator state keeps the
sample index modulo the (rational) period, so phase never loses precision no
matter how long the stream runs — f32 ``sin(2*pi*f*t)`` with a growing ``t``
decays to ~85 dB SNR within seconds, while the modular form stays exact.
Frequencies are rational: ``freq = num/den`` cycles per sample with
``num, den`` int32; the phase angle of sample n is
``2*pi * ((n * num) mod den) / den``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal, SignalProperties


def _rationalize(freq_hz: float, sample_rate: float, max_den: int = 1 << 20):
    """Express freq/sample_rate as an exact rational num/den (int32)."""
    from fractions import Fraction

    frac = Fraction(freq_hz / sample_rate).limit_denominator(max_den)
    return int(frac.numerator), int(frac.denominator)


def osc_block(n_mod, num, den, block_size):
    """Cos/sin of an exact-phase oscillator for one block.

    ``n_mod``: int32 scalar, current sample index modulo ``den``.
    Returns (cos, sin) each ``(block_size,)`` and the next ``n_mod``.
    """
    t = jnp.arange(block_size, dtype=jnp.int32)
    k = (n_mod + t) % den
    # k < den and num < den with den <= 2^14, so k*num < 2^28 fits int32;
    # the phase angle is promoted to float only AFTER the exact modulo.
    phase_idx = (k * num) % den
    angle = (2.0 * np.pi / den) * phase_idx.astype(jnp.float32)
    return jnp.cos(angle), jnp.sin(angle), (n_mod + block_size) % den


class Oscillator:
    """Ring modulator / frequency shifter: multiplies the signal by
    ``cos(2*pi*f*n/sr)`` with exact integer phase."""

    def __init__(self, freq_hz: float):
        self.freq_hz = freq_hz
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            # den <= 2^14 and num < den keeps k*num < 2^28, safe in int32.
            num, den = _rationalize(self.freq_hz, props.sample_rate, 1 << 14)

            def step(state, params, sig: Signal):
                c, _, n_next = osc_block(state["n"], num, den, sig.block_size)
                return {"n": n_next}, sig.with_data(sig.data * c[None, :])

            self._component = Processor(
                output=props,
                step=step,
                state={"n": jnp.asarray(0, jnp.int32)},
                params={},
            )
            return self._component

        return alloc


class IQMix:
    """Quadrature downconverter: (C, B) -> (2C, B) with interleaved
    [I..., Q...] channel blocks — the front half of any AM/FM/SSB
    demodulator. Follow with a lowpass FIR and a detector."""

    def __init__(self, freq_hz: float):
        self.freq_hz = freq_hz
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            num, den = _rationalize(self.freq_hz, props.sample_rate, 1 << 14)

            def step(state, params, sig: Signal):
                c, s, n_next = osc_block(state["n"], num, den, sig.block_size)
                i = sig.data * c[None, :]
                q = sig.data * (-s[None, :])
                return {"n": n_next}, Signal(
                    jnp.concatenate([i, q], axis=0), sig.frames
                )

            self._component = Processor(
                output=SignalProperties(
                    sample_rate=props.sample_rate, channels=2 * props.channels
                ),
                step=step,
                state={"n": jnp.asarray(0, jnp.int32)},
                params={},
            )
            return self._component

        return alloc


class EnvelopeDetector:
    """Magnitude detector over I/Q channel pairs: (2C, B) -> (C, B),
    ``sqrt(I^2 + Q^2)``. Combined IQMix -> lowpass FIR -> EnvelopeDetector
    forms a coherent AM demodulator."""

    def __init__(self):
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            if props.channels % 2 != 0:
                raise ValueError("EnvelopeDetector expects paired I/Q channels")
            self.context = mctx
            half = props.channels // 2

            def step(state, params, sig: Signal):
                i, q = sig.data[:half], sig.data[half:]
                return state, Signal(jnp.sqrt(i * i + q * q), sig.frames)

            self._component = Processor(
                output=SignalProperties(
                    sample_rate=props.sample_rate, channels=half
                ),
                step=step,
                state={},
                params={},
            )
            return self._component

        return alloc


def am_demod_factory(carrier_hz: float, lowpass_taps) -> list:
    """Processor allocator chain for a coherent AM demodulator:
    IQ mix down -> lowpass both rails -> envelope. Scale: mixing halves the
    baseband amplitude, so the envelope output is message/2 (plus filter
    transients)."""
    from pipe_tpu.ops.fir import FIR

    return [
        IQMix(carrier_hz).processor(),
        FIR(lowpass_taps).processor(),
        EnvelopeDetector().processor(),
    ]


class FMDiscriminator:
    """Quadrature FM discriminator over I/Q channel pairs:
    ``(2C, B) -> (C, B)`` of instantaneous frequency in cycles/sample,

        f[n] = atan2(I[n-1]Q[n] - Q[n-1]I[n], I[n-1]I[n] + Q[n-1]Q[n]) / 2π

    — the angle of ``z[n] * conj(z[n-1])``, exact for any deviation (no
    small-angle approximation) and elementwise. The previous
    I/Q sample carries across blocks, so the stream is continuous.
    Chain ``IQMix -> FIR lowpass -> FMDiscriminator`` for a complete FM
    receiver (see :func:`fm_demod_factory`)."""

    def __init__(self):
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            if props.channels % 2 != 0:
                raise ValueError("FMDiscriminator expects paired I/Q channels")
            self.context = mctx
            half = props.channels // 2

            def step(state, params, sig: Signal):
                B = sig.block_size
                # one (2C, 1+B) buffer: carried prev sample then the block
                buf = jnp.concatenate(
                    [state["prev"][:, None], sig.data], axis=1
                )
                i, q = sig.data[:half], sig.data[half:]
                ip, qp = buf[:half, :B], buf[half:, :B]  # rails shifted by 1
                re = ip * i + qp * q
                im = ip * q - qp * i
                f = jnp.arctan2(im, re) / (2.0 * np.pi)
                # prev <- sample at index `frames` of buf (the last valid)
                sel = lax.dynamic_slice(
                    buf, (0, sig.frames), (2 * half, 1)
                )[:, 0]
                return {"prev": sel}, Signal(f, sig.frames)

            self._component = Processor(
                output=SignalProperties(
                    sample_rate=props.sample_rate, channels=half
                ),
                step=step,
                state={"prev": jnp.zeros((2 * half,), jnp.float32)},
                params={},
            )
            return self._component

        return alloc


def fm_demod_factory(carrier_hz: float, lowpass_taps) -> list:
    """Processor allocator chain for an FM receiver: IQ mix down ->
    lowpass both rails -> quadrature discriminator. Output is the
    instantaneous frequency deviation from ``carrier_hz`` in
    cycles/sample (multiply by the sample rate for Hz)."""
    from pipe_tpu.ops.fir import FIR

    return [
        IQMix(carrier_hz).processor(),
        FIR(lowpass_taps).processor(),
        FMDiscriminator().processor(),
    ]
