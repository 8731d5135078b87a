"""Time-domain dynamics ops: delay/echo, peak compressor/limiter, noise
gate.

All recurrences are expressed scan-parallel (no sequential sample
loops):

- The release envelope follower ``env[n] = max(|x[n]|, r * env[n-1])`` is
  an associative recurrence over (decay, value) pairs:
  ``(a1, m1) . (a2, m2) = (a1*a2, max(m2, m1*a2))`` — evaluated with
  ``lax.associative_scan`` in O(log B) depth.
- The attack smoother is a first-order linear IIR, likewise an associative
  scan over affine (a, u) pairs.
- Delay lines are pure state slices (no recurrence) when
  ``delay >= block_size`` (the tap reads carried state only); shorter
  feedback delays run the in-block recurrence as D independent
  lane-parallel one-pole scans (compiled only when feedback is
  structurally enabled).

All tunables (times, thresholds, ratios, gains) are traced parameters —
live mutations never recompile. Coefficients like ``exp(-1/(tau*sr))`` are
computed from the traced values inside jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal, SignalProperties


def _decay_coef(time_ms, sample_rate):
    """One-pole coefficient for a time constant in milliseconds (traced)."""
    t = jnp.maximum(jnp.asarray(time_ms, jnp.float32), 1e-3)
    return jnp.exp(-1000.0 / (t * sample_rate))


def _attack_oma(time_ms, sample_rate):
    """``1 - coef`` for the attack smoother, computed DIRECTLY via expm1 so
    its f32 rounding is relative to (1-coef), not absolute near 1 — for
    slow attacks the absolute rounding of ``exp(...)`` perturbs the time
    constant by up to ``2^-24 / (1-coef)`` (~8e-4 at 300 ms), which the
    refined smoother in :func:`envelope_block` would otherwise inherit as
    an ~90 dB coefficient floor (docs/PERF_NOTES.md)."""
    t = jnp.maximum(jnp.asarray(time_ms, jnp.float32), 1e-3)
    return -jnp.expm1(-1000.0 / (t * sample_rate))


def _max_decay_combine(left, right):
    """Associative combine for ``env[n] = max(v[n], a * env[n-1])``."""
    a1, m1 = left
    a2, m2 = right
    return a1 * a2, jnp.maximum(m2, m1 * a2)


def _affine1_combine(left, right):
    """Associative combine for ``y[n] = a y[n-1] + u[n]`` (scalars)."""
    a1, u1 = left
    a2, u2 = right
    return a1 * a2, a2 * u1 + u2


def _pow_int(base, e_np):
    """``base ** e`` for STATIC integer exponents ``e >= 0``, correct for
    negative bases (float ``jnp.power`` returns NaN there)."""
    mag = jnp.abs(base) ** jnp.asarray(e_np, jnp.float32)
    sgn = jnp.where(
        base < 0, jnp.asarray(1.0 - 2.0 * (np.asarray(e_np) % 2), jnp.float32),
        1.0,
    )
    return mag * sgn


def envelope_block(env0, x_abs, frames, release_coef, attack_oma,
                   env0_lo=None):
    """Smoothed peak envelope over one block, attack smoother refined to
    the ~2^-24 output-rounding cap (VERDICT r2 item 4).

    The release follower's f32 max-decay scan injects only unamplified
    relative rounding; the attack one-pole, however, amplifies recurrence
    noise by kappa ~ 2*attack_ms*sr/1000, sinking below 100 dB past ~2 ms
    attacks. One iterative-refinement pass (the ``ops.biquad``
    ``_iir_refine`` mechanic on a first-order recurrence) removes it: the
    residual is evaluated with error-free transforms — including the dd
    complement of the f32 coefficient and the dd low word of the carried
    state — and the filtered correction is second-order small. Measured:
    flat 105-108 dB vs a TRUE-coefficient float64 oracle for attacks from
    0.5 to 300 ms (the residual ~107 dB floor is the release follower's
    unamplified f32 rounding, kappa-independent; the attack smoother
    alone matches an f32-coefficient oracle at ~150 dB) —
    docs/PERF_NOTES.md "Dynamics envelope precision".

    Args:
      env0: ``(C, 2)`` carried state: (release env, smoothed env) at the
        last valid frame of the previous block.
      x_abs: ``(C, B)`` rectified input (|x|), garbage beyond ``frames``.
      frames: traced int32 valid count.
      release_coef: traced scalar in (0, 1).
      attack_oma: traced scalar ``1 - attack_coef`` (see
        :func:`_attack_oma` for why the complement is the input).
      env0_lo: ``(C,)`` dd low word of the carried smoothed env (zeros if
        None).

    Returns ``(new_env0, new_env0_lo, env)`` with ``env`` (C, B) the
    smoothed envelope.
    """
    from pipe_tpu.ops.biquad import _opaque_one, _two_prod, _two_sum

    C, B = x_abs.shape
    idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    valid = idx < frames
    xa = jnp.where(valid, x_abs, 0.0)  # invalid frames only decay

    r = jnp.broadcast_to(release_coef, xa.shape)
    # seed the scan with the carried value: v[0] includes a * env0
    seed = jnp.zeros_like(xa).at[:, 0].set(release_coef * env0[:, 0])
    _, raw = lax.associative_scan(
        _max_decay_combine, (r, jnp.maximum(xa, seed)), axis=1
    )

    one = _opaque_one(attack_oma)
    oma = attack_oma
    # dd coefficient: ca_hi + ca_lo == 1 - oma exactly. Every intermediate
    # is laundered with ``one``: a plain two_sum(1.0, -oma) gets its error
    # channel constant-folded to zero by XLA (the literal-1.0 pattern is
    # simplified; measured). Both subtractions are Sterbenz-exact, so the
    # laundered form is exact too.
    ca_hi = (1.0 - oma) * one
    ca_lo = ((1.0 - ca_hi) * one - oma) * one
    e0 = env0[:, 1]
    if env0_lo is None:
        env0_lo = jnp.zeros((C,), jnp.float32)
    cab = jnp.broadcast_to(ca_hi, xa.shape)
    # um is the rounded product (oma*raw)*one — the scan's forcing — and
    # ue its exact error term, reused by the refinement residual
    um, ue = _two_prod(jnp.broadcast_to(oma, xa.shape), raw, one)
    u_seeded = um.at[:, 0].add(ca_hi * e0)
    _, y = lax.associative_scan(_affine1_combine, (cab, u_seeded), axis=1)
    # refinement: the residual of y against the ACCURATE recurrence
    # (error-free products/sums; ca_lo and the carried dd low word carry
    # the coefficient and state defects), filtered once more
    yprev = jnp.concatenate([e0[:, None], y[:, :-1]], axis=1)
    p, pe = _two_prod(cab, yprev, one)
    s, se = _two_sum(p, um)
    res = (s - y) + (pe + se + ue) + ca_lo * yprev
    res = res.at[:, 0].add(ca_hi * env0_lo)
    _, dy = lax.associative_scan(_affine1_combine, (cab, res), axis=1)
    env = (y + dy) * one

    # carry = values at the last VALID frame (frames-1); frames >= 1 in a
    # well-formed stream, clamp for safety. The smoothed-env carry keeps
    # its dd low word so the boundary does not re-quantize the state.
    last = jnp.clip(frames - 1, 0, B - 1)

    def at_last(v):
        return jnp.take_along_axis(v, jnp.full((C, 1), last), axis=1)[:, 0]

    eh, el = _two_sum(at_last(y), at_last(dy))
    new0 = jnp.stack([at_last(raw), eh], axis=1)
    return new0, el, env


def compressor_gain(env, threshold_db, ratio, makeup_db, floor=1e-8):
    """Hard-knee downward compression gain from a linear envelope."""
    env_db = 20.0 * jnp.log10(jnp.maximum(env, floor))
    over = jnp.maximum(env_db - threshold_db, 0.0)
    # ratio may be inf (limiter): 1 - 1/ratio -> 1
    slope = 1.0 - 1.0 / jnp.maximum(ratio, 1.0)
    gain_db = -over * slope + makeup_db
    return jnp.power(10.0, gain_db / 20.0)


class Delay:
    """Pure delay / feedback echo processor, for ANY ``delay_frames``.

    ``delay_frames`` of delay; ``feedback`` (traced) feeds the delayed
    OUTPUT back (classic echo); ``wet``/``dry`` (traced) mix the delayed
    and direct paths.

    Feedback capability is structural (mirrors the sharded twin,
    ``parallel.chain.DelayStage``): with ``D >= block_size`` the tap reads
    carried state only and feedback is free, so it is always enabled; for
    ``D < block_size`` the recurrence needs a lane-parallel scan inside
    the block, compiled only when requested — build with a nonzero
    ``feedback`` or ``allow_feedback=True``, else ``set_feedback`` raises.
    """

    def __init__(self, delay_frames: int, feedback: float = 0.0,
                 wet: float = 1.0, dry: float = 0.0,
                 allow_feedback=None):
        if delay_frames < 1:
            raise ValueError("delay_frames must be >= 1")
        if allow_feedback is False and feedback != 0.0:
            raise ValueError(
                "contradictory arguments: nonzero feedback with "
                "allow_feedback=False"
            )
        self.delay_frames = delay_frames
        self._feedback = feedback
        self._wet = wet
        self._dry = dry
        self._allow_feedback = allow_feedback
        self._component = None
        self.context = None

    def processor(self):
        D = self.delay_frames

        def alloc(mctx, block_size, props: SignalProperties):
            # D >= block: the tap reads carried state only — feedback is
            # structurally free. D < block: the in-block recurrence scan
            # is compiled only when feedback was requested.
            can_feedback = (
                D >= block_size
                or self._feedback != 0.0
                or bool(self._allow_feedback)
            )
            self._can_feedback = can_feedback
            self.context = mctx
            C = props.channels
            B = block_size
            scan_path = can_feedback and D < B
            # D >= B: the delay line is a MIRRORED RING — every sample is
            # written at its canonical ring index (pos mod L) AND at the
            # mirror (pos mod L) + L, so any L-window read is one
            # contiguous slice and the per-block state traffic is O(B),
            # not O(D) (the concat shift re-wrote all D samples per block
            # — dominant for long echo lines; same mechanic as the UPOLS
            # ring FDL, docs/PERF_NOTES.md). Reads precede writes and
            # L = D + B, so the tap window [t-D, t-D+B) always holds
            # valid history.
            #
            # Layout: [pad B | canonical L | mirror L | pad B]. A block
            # write lands at THREE starts: B+pos (canonical + spill into
            # the mirror when it wraps), B+pos+L (mirror + spill into the
            # right pad), and B+pos-L (left pad when there is no wrap —
            # dynamic_update_slice clamps the negative start into the
            # pad — or, on a wrap, exactly the canonical low indices
            # [0, pos+B-L) that the first write could only reach as
            # mirrors). Without the third write those low canonical
            # slots went stale whenever pos+B > L, i.e. whenever
            # delay_frames % block_size != 0 or after a partial block
            # (ADVICE r3, high).
            ring_path = D >= B
            L = D + B

            def step(state, params, sig: Signal):
                # The delay line carries the stream s = x + fb * s[n-D]
                # (s = x without feedback). Output is dry*x + wet*s[n-D].
                x = sig.data
                idx = jnp.arange(B, dtype=jnp.int32)[None, :]
                xm = jnp.where(idx < sig.frames, x, 0.0)
                fb = params["feedback"]
                if ring_path:
                    ring = state["ring"]  # (C, B + 2L + B), see above
                    pos = state["pos"]  # stream position mod L
                    r0 = (pos - D) % L
                    delayed = lax.dynamic_slice(ring, (0, B + r0), (C, B))
                    s = xm + fb * delayed if can_feedback else xm
                    ring = lax.dynamic_update_slice(ring, s, (0, B + pos))
                    ring = lax.dynamic_update_slice(
                        ring, s, (0, B + pos + L)
                    )
                    # wrapped-write repair: clamps into the left pad when
                    # pos + B <= L, else writes s's tail at canonical
                    # [0, pos+B-L)
                    ring = lax.dynamic_update_slice(
                        ring, s, (0, pos + (B - L))
                    )
                    y = params["dry"] * xm + params["wet"] * delayed
                    new_state = {
                        "ring": ring, "pos": (pos + sig.frames) % L
                    }
                    return new_state, sig.with_data(y)
                hist = state["hist"]  # (C, D): trailing D samples of s
                if not scan_path:
                    delayed = jnp.concatenate([hist, xm], axis=1)[:, :B]
                    s = xm
                else:
                    # in-block recurrence: D independent lanes, each a
                    # one-pole over its own samples (the sharded stage's
                    # mechanic, single-device: the carry IS the entering
                    # history). Lanes beyond `frames` compute garbage that
                    # the frames-sliced carry never reads.
                    w = (-B) % D
                    m = (B + w) // D
                    rows = jnp.pad(xm, ((0, 0), (w, 0))).reshape(C, m, D)
                    a = jnp.broadcast_to(fb, rows.shape)
                    _, s0r = lax.associative_scan(
                        _affine1_combine, (a, rows), axis=1
                    )
                    s0 = s0r.reshape(C, m * D)[:, w:]
                    i = np.arange(B)
                    s = s0 + _pow_int(fb, i // D + 1)[None, :] * hist[:, i % D]
                    delayed = jnp.concatenate([hist, s[:, : B - D]], axis=1)
                y = params["dry"] * xm + params["wet"] * delayed
                buf = jnp.concatenate([hist, s], axis=1)
                new_hist = lax.dynamic_slice(buf, (0, sig.frames), (C, D))
                return {"hist": new_hist}, sig.with_data(y)

            if ring_path:
                # B + 2L + B: left pad absorbs the no-wrap repair write,
                # right pad the mirror write's spill (pad bytes are never
                # read)
                state0 = {
                    "ring": jnp.zeros((C, 2 * L + 2 * B), jnp.float32),
                    "pos": jnp.zeros((), jnp.int32),
                }
            else:
                state0 = {"hist": jnp.zeros((C, D), jnp.float32)}
            self._component = Processor(
                output=props,
                step=step,
                state=state0,
                params={
                    "feedback": jnp.asarray(self._feedback, jnp.float32),
                    "wet": jnp.asarray(self._wet, jnp.float32),
                    "dry": jnp.asarray(self._dry, jnp.float32),
                },
            )
            return self._component

        return alloc

    def set_feedback(self, fb):
        if not getattr(self, "_can_feedback", True):
            raise ValueError(
                "this Delay cannot do feedback: it was built pure with "
                "delay_frames < block_size (pass feedback=... or "
                "allow_feedback=True at construction)"
            )
        v = jnp.asarray(fb, jnp.float32)

        def fn():
            self._component.set_param("feedback", v)

        return self.context.mutate(fn)

    def set_mix(self, wet, dry):
        w, d = jnp.asarray(wet, jnp.float32), jnp.asarray(dry, jnp.float32)

        def fn():
            self._component.set_param("wet", w)
            self._component.set_param("dry", d)

        return self.context.mutate(fn)


class Compressor:
    """Peak compressor / limiter (``ratio=inf``) with attack/release
    envelope. All parameters live-mutable without recompiles."""

    def __init__(self, threshold_db: float = -18.0, ratio: float = 4.0,
                 attack_ms: float = 5.0, release_ms: float = 120.0,
                 makeup_db: float = 0.0):
        self._p = dict(
            threshold_db=threshold_db, ratio=ratio, attack_ms=attack_ms,
            release_ms=release_ms, makeup_db=makeup_db,
        )
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C = props.channels
            sr = props.sample_rate

            def step(state, params, sig: Signal):
                rc = _decay_coef(params["release_ms"], sr)
                ao = _attack_oma(params["attack_ms"], sr)
                new0, new_lo, env = envelope_block(
                    state["env"], jnp.abs(sig.data), sig.frames, rc, ao,
                    state["env_lo"],
                )
                g = compressor_gain(
                    env, params["threshold_db"], params["ratio"],
                    params["makeup_db"],
                )
                return (
                    {"env": new0, "env_lo": new_lo},
                    sig.with_data(sig.data * g),
                )

            self._component = Processor(
                output=props,
                step=step,
                state={
                    "env": jnp.zeros((C, 2), jnp.float32),
                    "env_lo": jnp.zeros((C,), jnp.float32),
                },
                params={
                    k: jnp.asarray(v, jnp.float32) for k, v in self._p.items()
                },
            )
            return self._component

        return alloc

    def set(self, **kwargs):
        """Mutate any of threshold_db / ratio / attack_ms / release_ms /
        makeup_db."""
        vals = {k: jnp.asarray(v, jnp.float32) for k, v in kwargs.items()}
        unknown = set(vals) - set(self._p)
        if unknown:
            raise KeyError(f"unknown compressor params: {sorted(unknown)}")

        def fn():
            for k, v in vals.items():
                self._component.set_param(k, v)

        return self.context.mutate(fn)


class NoiseGate:
    """Downward expander gate: attenuates by ``range_db`` when the smoothed
    envelope falls below ``threshold_db``."""

    def __init__(self, threshold_db: float = -50.0, range_db: float = 80.0,
                 attack_ms: float = 1.0, release_ms: float = 200.0):
        self._p = dict(
            threshold_db=threshold_db, range_db=range_db,
            attack_ms=attack_ms, release_ms=release_ms,
        )
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C = props.channels
            sr = props.sample_rate

            def step(state, params, sig: Signal):
                rc = _decay_coef(params["release_ms"], sr)
                ao = _attack_oma(params["attack_ms"], sr)
                new0, new_lo, env = envelope_block(
                    state["env"], jnp.abs(sig.data), sig.frames, rc, ao,
                    state["env_lo"],
                )
                env_db = 20.0 * jnp.log10(jnp.maximum(env, 1e-8))
                atten = jnp.power(10.0, -params["range_db"] / 20.0)
                g = jnp.where(env_db >= params["threshold_db"], 1.0, atten)
                return (
                    {"env": new0, "env_lo": new_lo},
                    sig.with_data(sig.data * g),
                )

            self._component = Processor(
                output=props,
                step=step,
                state={
                    "env": jnp.zeros((C, 2), jnp.float32),
                    "env_lo": jnp.zeros((C,), jnp.float32),
                },
                params={
                    k: jnp.asarray(v, jnp.float32) for k, v in self._p.items()
                },
            )
            return self._component

        return alloc

    def set(self, **kwargs):
        vals = {k: jnp.asarray(v, jnp.float32) for k, v in kwargs.items()}
        unknown = set(vals) - set(self._p)
        if unknown:
            raise KeyError(f"unknown gate params: {sorted(unknown)}")

        def fn():
            for k, v in vals.items():
                self._component.set_param(k, v)

        return self.context.mutate(fn)
