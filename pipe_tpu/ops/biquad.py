"""Biquad IIR EQ via parallel (associative) scan (benchmark config 4's 'EQ
chain').

A direct-form biquad is a sequential recurrence — poison for a vector
machine. Rewritten as an affine recurrence over 2-vectors,

    s[n] = A s[n-1] + u[n],   A = [[-a1, -a2], [1, 0]],
    u[n] = (b0 x[n] + b1 x[n-1] + b2 x[n-2], 0),

the whole block is evaluated with ``jax.lax.associative_scan`` over
(matrix, vector) pairs in O(log B) depth — a parallel formulation of an
IIR filter (on the CPU, large blocks take a scan of Toeplitz tile matmuls
instead, :func:`_iir_path`). The FIR part of u[n] is a 3-tap streaming FIR
reusing the same tail mechanics as :mod:`pipe_tpu.ops.fir`.

Numerics: one iterative-refinement pass (default) lifts the f32 engine to
>= 100 dB against a float64 oracle wherever the f32 noise-gain floor
allows (docs/PERF_NOTES.md "kappa floor": any q <= 10 at >= 1 kHz at
44.1 kHz); ``precision='extended'`` (double-f32) clears 100 dB down to
20 Hz sections. Cascades are applied section by section.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pipe_tpu.components import Processor
from pipe_tpu.signal import Signal


def _affine_combine(left, right):
    """Compose affine maps: (A2, u2) after (A1, u1) = (A2@A1, A2@u1 + u2).

    Shapes carry leading batch dims (..., 2, 2) and (..., 2).
    """
    A1, u1 = left
    A2, u2 = right
    hi = lax.Precision.HIGHEST
    A = jnp.einsum("...ij,...jk->...ik", A2, A1, precision=hi)
    u = jnp.einsum("...ij,...j->...i", A2, u1, precision=hi) + u2
    return A, u


def _iir_sequences(a1, a2, Q: int):
    """Length-Q impulse/boundary responses of ``y[n] = v[n] - a1 y[n-1]
    - a2 y[n-2]`` built with one tiny scan from the TRACED coefficients:

      g[i]     — response to v = delta (zero initial state)
      alpha[i] — response to y[-1] = 1 (v = 0)
      beta[i]  — response to y[-2] = 1 (v = 0)

    Every tile of the recurrence is then EXACTLY
    ``y = Tl @ v + y_prev1 * alpha + y_prev2 * beta`` with
    ``Tl[i, j] = g[i-j]`` — a lower-triangular Toeplitz matmul plus
    rank-2 boundary terms, replacing the sequential scan.
    """
    # Run all three recurrences together on a (3,) carry pair (y[n-1], y[n-2]).
    # Values at i=0:  g[0]=1 (v=delta);  alpha[0]=-a1 (y[-1]=1);
    # beta[0]=-a2 (y[-2]=1).  Values at i=-1: g[-1]=0, alpha[-1]=y[-1]=1,
    # beta[-1]=0 (beta's unit sits at y[-2], one step earlier).
    one, zero = jnp.ones_like(a1), jnp.zeros_like(a1)
    y0 = jnp.stack([one, -a1, -a2])
    ym1 = jnp.stack([zero, one, zero])

    def step(carry, _):
        y1, y2 = carry
        y = -a1 * y1 - a2 * y2
        return (y, y1), y

    (_, _), tail = lax.scan(step, (y0, ym1), None, length=Q - 1)
    seqs = jnp.concatenate([y0[None], tail], axis=0)  # (Q, 3)
    return seqs[:, 0], seqs[:, 1], seqs[:, 2]  # g, alpha, beta


def _iir_tiles(v, s, TlT, ab, Q: int):
    """Tile loop (lax.scan): carry (C, 2) = (y[-1], y[-2])."""
    C, B = v.shape
    tiles = v.reshape(C, B // Q, Q).transpose(1, 0, 2)  # (n, C, Q)

    def step(carry, vt):
        y = jnp.dot(
            vt, TlT, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
        y = y + carry[:, 0:1] * ab[0:1, :] + carry[:, 1:2] * ab[1:2, :]
        return jnp.stack([y[:, -1], y[:, -2]], axis=1), y

    _, ys = lax.scan(step, s, tiles)
    return ys.transpose(1, 0, 2).reshape(C, B)


# Tile size and cut-over of the tiled engine. The GPU never takes it: on an
# H100 (80GB HBM3, 700 W) the scan of tile matmuls ran 4.4-6.2 ms per call
# at every (C, B) from (2, 512) to (64, 8192) against 0.16-0.25 ms for the
# associative scan, and the config-4 step (OLS 64k + refined EQ, C=16,
# B=8192) took 6.26 ms against 0.32 ms (benchmarks/sweep.py). On the CPU
# the tiled engine is the faster one for large blocks.
_TILE_Q = 256
_TILE_MIN_B = 2048


def _iir_path(B: int, backend: str | None = None) -> str:
    """Which engine :func:`_iir_apply` runs for a B-frame block: the
    associative scan on the GPU; elsewhere the tiled engine for blocks of
    at least ``_TILE_MIN_B`` frames in whole tiles."""
    if backend is None:
        backend = jax.default_backend()
    if backend != "gpu" and B % _TILE_Q == 0 and B >= _TILE_MIN_B:
        return "tiles"
    return "assoc"


def _iir_apply(v, s, a1, a2, path: str | None = None):
    """Dispatch the recurrence ``y[n] = v[n] - a1 y[n-1] - a2 y[n-2]``
    to the associative scan or the tiled Toeplitz engine (a scan of tile
    matmuls), as :func:`_iir_path` picks. ``path`` pins an engine:
    'assoc' | 'tiles'.
    """
    C, B = v.shape
    if path is None:
        path = _iir_path(B)

    if path == "assoc":
        A = jnp.stack(
            [jnp.stack([-a1, -a2]),
             jnp.stack([jnp.ones_like(a1), jnp.zeros_like(a1)])]
        )  # (2, 2)
        us = jnp.stack([v, jnp.zeros_like(v)], axis=-1)  # (C, B, 2)
        us_t = jnp.swapaxes(us, 0, 1)  # (B, C, 2)
        As_b = jnp.broadcast_to(A[None, None], (B, v.shape[0], 2, 2))
        P, q = lax.associative_scan(_affine_combine, (As_b, us_t), axis=0)
        s_all = (
            jnp.einsum("bcij,cj->bci", P, s, precision=lax.Precision.HIGHEST)
            + q
        )
        return jnp.swapaxes(s_all[..., 0], 0, 1)  # (C, B)

    Q = _TILE_Q
    g, alpha, beta = _iir_sequences(a1, a2, Q)
    i = jnp.arange(Q)[:, None]
    j = jnp.arange(Q)[None, :]
    TlT = jnp.where(i <= j, g[jnp.clip(j - i, 0, Q - 1)], 0.0)  # Tl^T (Q, Q)
    ab = jnp.stack([alpha, beta], axis=0)  # (2, Q)
    return _iir_tiles(v, s, TlT, ab, Q)


# ---------------------------------------------------------------------------
# Extended precision: double-f32 (two-float) recurrence
#
# The f32 noise-gain floor (docs/PERF_NOTES.md "kappa floor") comes from
# ~2^-24-relative rounding injected *between* B(z) and 1/A(z): the recurrence
# amplifies it by kappa = ||1/A||_2 (hundreds for sub-200 Hz sections at
# 44.1 kHz). No f32 reformulation escapes it — but carrying the forcing v,
# the pole recurrence, and the section state as UNEVALUATED f32 PAIRS
# (hi + lo, Dekker/Knuth error-free transforms: ~2^-48 effective precision)
# drops the injected noise to 2^-48 * kappa, far below the 2^-24 cap of the
# final output rounding. All ops are exact-f32 elementwise arithmetic, no
# f64. Opt in with ``Biquad(..., precision='extended')``.
# ---------------------------------------------------------------------------

_SPLIT_F32 = 4097.0  # 2**12 + 1 — Veltkamp split constant for float32


def _opaque_one(x):
    """A runtime 1.0f the compiler cannot constant-fold: ``x*0 + 1`` stays
    data-dependent because XLA preserves the NaN/Inf semantics of ``x*0``.

    Why: error-free transforms require every product to be ROUNDED before
    it enters a sum. XLA:CPU's LLVM backend contracts ``p = a*b; s = p+q``
    into ``s = fma(a, b, q)`` (verified: the jitted sum differs from the
    rounded-product sum by 1 ulp and the captured error term is garbage —
    and neither ``lax.optimization_barrier`` nor int-bitcast round-trips
    survive to codegen). Multiplying every product by this runtime one
    makes any remaining contraction compute ``fma(p, 1, q) = round(p+q)``
    — exactly the required semantics either way.

    The operand ``x`` MUST be a traced (runtime) value: if it is a
    compile-time constant, XLA folds ``x*0 + 1`` to a literal 1.0, the
    algebraic simplifier strips the ``* 1``, fma contraction returns, and
    the dd layer silently degrades to the f32 kappa floor. Every in-tree
    caller threads coefficients as jit parameters; direct users of
    ``biquad_block`` with constant coefficients should pass them as traced
    arrays (or derive ``one`` from the always-traced signal buffer).
    ``tests/test_ops.py::test_dd_transforms_exact_under_jit`` pins this on
    the CPU and ``tests/test_on_card.py`` on the GPU."""
    return x * 0.0 + 1.0


def _two_sum(a, b):
    """Error-free a + b = s + e (Knuth). Operands must not be raw product
    values (see :func:`_opaque_one`); all dd-layer products are laundered
    at creation, so plain sums here are safe."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """Error-free a + b = s + e, requiring |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b, one):
    """Error-free a * b = p + e via Veltkamp splitting (XLA's CPU and GPU
    backends contract mul+add into FMA, so every product is pinned with
    ``one``)."""
    p = (a * b) * one
    ca = (a * _SPLIT_F32) * one
    ah = ca - (ca - a)
    al = a - ah
    cb = (b * _SPLIT_F32) * one
    bh = cb - (cb - b)
    bl = b - bh
    e = (((ah * bh) * one - p) + (ah * bl) * one + (al * bh) * one)
    return p, e + (al * bl) * one


def _dd_add(x, y):
    """Accurate dd + dd (QD-library 'ieee_add' shape): the sloppy
    single-renormalize variant loses its error channel under the heavy
    cancellation a resonant recurrence produces."""
    s1, s2 = _two_sum(x[0], y[0])
    t1, t2 = _two_sum(x[1], y[1])
    s1, s2 = _fast_two_sum(s1, s2 + t1)
    return _fast_two_sum(s1, s2 + t2)


def _dd_mul(x, y, one):
    p, e = _two_prod(x[0], y[0], one)
    return _fast_two_sum(
        p, e + ((x[0] * y[1]) * one + (x[1] * y[0]) * one)
    )


def _dd_neg(x):
    return -x[0], -x[1]


def split_f32_pair(v) -> np.ndarray:
    """Host-side: float64 array -> (2, ...) f32 [hi, lo] with hi+lo == v to
    f32-pair precision. The lo plane is what ``precision='extended'``
    threads through the recurrence."""
    v = np.asarray(v, np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return np.stack([hi, lo])


def _dd_affine_combine(left, right, one):
    """Affine-map composition (the assoc-scan element of `_affine_combine`)
    in double-f32: elements are 6 dd pairs (a, b, c, d, ux, uy) for
    A = [[a, b], [c, d]], u = (ux, uy)."""
    la, lb, lc, ld, lux, luy = left
    ra, rb, rc, rd, rux, ruy = right
    a = _dd_add(_dd_mul(ra, la, one), _dd_mul(rb, lc, one))
    b = _dd_add(_dd_mul(ra, lb, one), _dd_mul(rb, ld, one))
    c = _dd_add(_dd_mul(rc, la, one), _dd_mul(rd, lc, one))
    d = _dd_add(_dd_mul(rc, lb, one), _dd_mul(rd, ld, one))
    ux = _dd_add(_dd_add(_dd_mul(ra, lux, one), _dd_mul(rb, luy, one)), rux)
    uy = _dd_add(_dd_add(_dd_mul(rc, lux, one), _dd_mul(rd, luy, one)), ruy)
    return a, b, c, d, ux, uy


def _dd_identity_elem(shape):
    one = jnp.ones(shape, jnp.float32)
    zero = jnp.zeros(shape, jnp.float32)
    z = (zero, zero)
    return (one, zero), z, z, (one, zero), z, z


def _dd_forcing(buf, coefs, coefs_lo):
    """v = b0 x + b1 x[-1] + b2 x[-2] over an f32 buffer (C, B+2), with
    double-f32 coefficients, accumulated error-free. Returns a dd pair."""
    b = [(coefs[i], coefs_lo[i]) for i in range(3)]
    one = _opaque_one(coefs[0])
    x0, x1, x2 = buf[:, 2:], buf[:, 1:-1], buf[:, :-2]
    t = None
    for (bh, bl), xk in zip(b, (x0, x1, x2)):
        p, e = _two_prod(bh, xk, one)
        term = _fast_two_sum(p, e + (bl * xk) * one)
        t = term if t is None else _dd_add(t, term)
    return t


def _dd_prefix_scan(elems, one):
    """Inclusive prefix-combine over axis 1 by prefix doubling
    (Hillis–Steele): ``prefix[i] = combine(prefix[i - k], prefix[i])``
    for k = 1, 2, 4, ...

    Deliberately NOT ``lax.associative_scan``: its jitted lowering loses
    the dd error channels — measured 5e-4 rms recurrence error under jit
    vs 1e-8 eager on a |pole|=0.9975 section (fp contraction inside its
    odd/even recursion, see :func:`_opaque_one`) — while this explicit
    slice/concat form with laundered products is accurate under jit on
    both backends. O(N log N) combines instead of O(N): acceptable for
    the opt-in extended-precision path. (The dynamics attack smoother
    deliberately does NOT use a dd scan — it gets the same accuracy from
    one plain-f32 refinement pass, ``ops.dynamics.envelope_block``.)"""
    n = elems[0][0].shape[1]
    pref = elems
    k = 1
    while k < n:
        shifted = jax.tree.map(lambda x: x[:, :-k], pref)
        rest = jax.tree.map(lambda x: x[:, k:], pref)
        comb = _dd_affine_combine(shifted, rest, one)
        pref = jax.tree.map(
            lambda p, c: jnp.concatenate([p[:, :k], c], axis=1), pref, comb
        )
        k *= 2
    return pref


def _iir_scan_dd(v_dd, a1_dd, a2_dd, one):
    """Inclusive prefix of the companion-affine elements for
    ``y[n] = v[n] - a1 y[n-1] - a2 y[n-2]`` in double-f32, over axis 1.

    Returns the six per-sample dd prefixes (a, b, c, d, ux, uy):
    ``y[n] = a[n] s_x + b[n] s_y + ux[n]`` for entering state
    s = (y[-1], y[-2])."""
    vh, vl = v_dd
    shape = vh.shape
    na1 = _dd_neg(a1_dd)
    na2 = _dd_neg(a2_dd)
    bc = lambda t: (
        jnp.broadcast_to(t[0], shape), jnp.broadcast_to(t[1], shape)
    )
    zero = jnp.zeros(shape, jnp.float32)
    unit = jnp.ones(shape, jnp.float32)
    elems = (
        bc(na1), bc(na2), (unit, zero), (zero, zero),
        (vh, vl), (zero, zero),
    )
    return _dd_prefix_scan(elems, one)


def _dd_apply_boundary(prefix, s_dd, one):
    """y[n] = a[n] s_x + b[n] s_y + ux[n] in dd. ``s_dd`` is an
    ((C, 2) hi, (C, 2) lo) state pair; returns the per-sample dd output."""
    a, b, _, _, ux, _ = prefix
    sx = (s_dd[0][:, 0:1], s_dd[1][:, 0:1])
    sy = (s_dd[0][:, 1:2], s_dd[1][:, 1:2])
    return _dd_add(_dd_add(_dd_mul(a, sx, one), _dd_mul(b, sy, one)), ux)


def _iir_apply_dd(v_dd, s_dd, a1_dd, a2_dd):
    """Double-f32 pole recurrence over a block: returns the dd output pair
    ((C, B) hi, lo). ~2^-48 effective state precision — the injected
    recurrence noise is 2^-48 * kappa instead of 2^-24 * kappa."""
    one = _opaque_one(a1_dd[0])
    return _dd_apply_boundary(
        _iir_scan_dd(v_dd, a1_dd, a2_dd, one), s_dd, one
    )


def _iir_refine(v, s, y, a1, a2):
    """One step of iterative refinement on the pole recurrence: compute the
    f32 defect ``r[n] = v[n] - (y[n] + a1 y[n-1] + a2 y[n-2])`` and add the
    filtered defect back. The defect is ~2^-24 of the signal, so the
    correction pass runs in clean f32 — measured gain on a |pole|=0.994 EQ:
    98 -> 105 dB (tiles) and 87 -> ~100+ dB (assoc) vs a float64 oracle.
    Doubles the recurrence cost; disable with ``Biquad(refine=False)``."""
    yp = jnp.concatenate([s[:, ::-1], y], axis=1)  # [y[-2], y[-1], y...]
    r = v - (y + a1 * yp[:, 1:-1] + a2 * yp[:, :-2])
    return y + _iir_apply(r, jnp.zeros_like(s), a1, a2)


def biquad_section_block(state, x, frames, coefs, refine: bool = True):
    """One block through one biquad section.

    Args:
      state: dict with ``x_tail`` (C, 2) and ``s`` (C, 2) = (y[n-1], y[n-2]).
      x: (C, B) input, valid to ``frames``.
      frames: traced int32.
      coefs: (6,) array [b0, b1, b2, 1, a1, a2] (a0 normalized to 1).
      refine: run one iterative-refinement pass on the pole recurrence
        (see :func:`_iir_refine`). Per-block refinement against the
        corrected carried state is self-consistent: the correction is
        absorbed into the carry, so nothing rings past a block unseen.

    Returns (new_state, y).
    """
    C, B = x.shape
    b0, b1, b2 = coefs[0], coefs[1], coefs[2]
    a1, a2 = coefs[4], coefs[5]
    idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    xm = jnp.where(idx < frames, x, 0.0)

    # FIR part v[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] with carried tail
    buf = jnp.concatenate([state["x_tail"], xm], axis=1)  # (C, B+2)
    v = b0 * buf[:, 2:] + b1 * buf[:, 1:-1] + b2 * buf[:, :-2]  # (C, B)

    # Recurrence. The carried state is s = (y[-1], y[-2]).
    s_init = state["s"]  # (C, 2)
    y = _iir_apply(v, s_init, a1, a2)  # (C, B)
    if refine:
        y = _iir_refine(v, s_init, y, a1, a2)

    # next state: (y, y-1) after the last VALID frame. y_hist[k] = y[k-2],
    # so the state after `frames` frames is (y_hist[frames+1], y_hist[frames])
    # — frames=0 keeps the carried state.
    y_hist = jnp.concatenate([s_init[:, 1:2], s_init[:, 0:1], y], axis=1)
    pair = lax.dynamic_slice(y_hist, (0, frames), (C, 2))  # (y[f-2], y[f-1])
    new_s = pair[:, ::-1]
    new_x_tail = lax.dynamic_slice(buf, (0, frames), (C, 2))
    return {"x_tail": new_x_tail, "s": new_s}, y


def biquad_section_block_extended(state, x, frames, coefs, coefs_lo):
    """One block through one section in double-f32 (two-float) precision.

    Same contract as :func:`biquad_section_block` plus ``coefs_lo`` (the
    low f32 planes of the float64 coefficients, `split_f32_pair`) and an
    ``s_lo`` state entry. The forcing, the pole recurrence, and the carried
    state all stay unevaluated f32 pairs; only the block output is rounded
    once — so the section's error vs a float64 oracle is ~2^-24 flat
    instead of 2^-24 * kappa (see docs/PERF_NOTES.md, 'kappa floor').
    Inter-section and inter-block signals stay single f32: input-referred
    noise passes through the full H = B/A (modest gain), not 1/A alone.
    """
    C, B = x.shape
    a1 = (coefs[4], coefs_lo[4])
    a2 = (coefs[5], coefs_lo[5])
    idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    xm = jnp.where(idx < frames, x, 0.0)
    buf = jnp.concatenate([state["x_tail"], xm], axis=1)
    v = _dd_forcing(buf, coefs, coefs_lo)
    yh, yl = _iir_apply_dd(v, (state["s"], state["s_lo"]), a1, a2)
    y_hist_h = jnp.concatenate(
        [state["s"][:, 1:2], state["s"][:, 0:1], yh], axis=1
    )
    y_hist_l = jnp.concatenate(
        [state["s_lo"][:, 1:2], state["s_lo"][:, 0:1], yl], axis=1
    )
    pair_h = lax.dynamic_slice(y_hist_h, (0, frames), (C, 2))
    pair_l = lax.dynamic_slice(y_hist_l, (0, frames), (C, 2))
    new_state = {
        "x_tail": lax.dynamic_slice(buf, (0, frames), (C, 2)),
        "s": pair_h[:, ::-1],
        "s_lo": pair_l[:, ::-1],
    }
    return new_state, yh


def biquad_block(state, x, frames, sections, refine: bool = True,
                 sections_lo=None):
    """Cascade of biquad sections. ``sections``: (S, 6) SOS matrix (scipy
    layout, a0 == 1). ``state``: list of per-section dicts. Passing
    ``sections_lo`` (the low f32 planes) selects the double-f32 extended
    path per section."""
    new_states = []
    y = x
    for i in range(sections.shape[0]):
        if sections_lo is None:
            st, y = biquad_section_block(
                state[i], y, frames, sections[i], refine=refine
            )
        else:
            st, y = biquad_section_block_extended(
                state[i], y, frames, sections[i], sections_lo[i]
            )
        new_states.append(st)
    return new_states, y


def biquad_init_state(channels: int, n_sections: int, extended: bool = False):
    z2 = lambda: jnp.zeros((channels, 2), jnp.float32)
    return [
        {"x_tail": z2(), "s": z2(), **({"s_lo": z2()} if extended else {})}
        for _ in range(n_sections)
    ]


class Biquad:
    """Biquad cascade processor from an SOS matrix (scipy ``sosfilt``
    layout: rows [b0 b1 b2 a0 a1 a2], a0 normalized to 1). Coefficients are
    a live parameter (section count fixed).

    ``precision='extended'`` runs the cascade in double-f32 (two-float)
    arithmetic: coefficients, forcing, recurrence, and carried state all
    ride as f32 hi/lo pairs (~2^-48), so near-DC / high-Q sections whose
    f32 noise-gain floor sits below 100 dB (kappa = ||1/A||_2 amplification,
    docs/PERF_NOTES.md) still land at the flat ~2^-24 output-rounding cap
    (~138 dB). Costs ~25x the default tiled path on CPU (measured,
    docs/PERF_NOTES.md); the default f32 engine (with refinement) is the
    right choice whenever its floor clears the target."""

    def __init__(self, sos, refine: bool = True, precision: str | None = None):
        if precision not in (None, "extended"):
            raise ValueError("precision must be None or 'extended'")
        self._extended = precision == "extended"
        self._sos64 = self._normalize(sos)
        pair = split_f32_pair(self._sos64)
        self._sos = jnp.asarray(pair[0])
        self._sos_lo = jnp.asarray(pair[1])
        self._refine = bool(refine)
        self._component = None
        self._delegate = None  # set by pipe_tpu.optimize.fuse
        self.context = None

    @staticmethod
    def _normalize(sos) -> np.ndarray:
        sos = np.asarray(sos, np.float64)
        if sos.ndim == 1:
            sos = sos[None, :]
        if sos.shape[-1] != 6:
            raise ValueError("sos rows must be [b0 b1 b2 a0 a1 a2]")
        return sos / sos[:, 3:4]

    def processor(self):
        def alloc(mctx, block_size, props):
            self.context = mctx
            S = self._sos.shape[0]

            refine = self._refine
            extended = self._extended

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

        alloc.fusion_tag = ("biquad", self)
        return alloc

    @property
    def n_sections(self) -> int:
        return int(self._sos.shape[0])

    def set_sos(self, sos):
        if self._delegate is not None:  # cascaded away by optimize.fuse
            return self._delegate.set_part_sos(self, sos)
        pair = split_f32_pair(self._normalize(sos))
        hi = jnp.asarray(pair[0])
        lo = jnp.asarray(pair[1])

        def fn():
            self._component.set_param("sos", hi)
            self._component.set_param("sos_lo", lo)

        return self.context.mutate(fn)


def _rbj_row(b0, b1, b2, a0, a1, a2) -> np.ndarray:
    return np.array([b0 / a0, b1 / a0, b2 / a0, 1.0, a1 / a0, a2 / a0])


def _rbj_wa(sample_rate: float, freq: float, q: float):
    w0 = 2.0 * np.pi * freq / sample_rate
    return w0, np.sin(w0) / (2.0 * q)


def design_peaking_eq(
    sample_rate: float, freq: float, q: float, gain_db: float
) -> np.ndarray:
    """RBJ cookbook peaking EQ, one SOS row, float64 host-side."""
    A = 10.0 ** (gain_db / 40.0)
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    return _rbj_row(
        1 + alpha * A, -2 * np.cos(w0), 1 - alpha * A,
        1 + alpha / A, -2 * np.cos(w0), 1 - alpha / A,
    )


def design_lowpass_biquad(
    sample_rate: float, freq: float, q: float = 0.7071
) -> np.ndarray:
    """RBJ 2nd-order lowpass, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(
        (1 - c) / 2, 1 - c, (1 - c) / 2, 1 + alpha, -2 * c, 1 - alpha
    )


def design_highpass_biquad(
    sample_rate: float, freq: float, q: float = 0.7071
) -> np.ndarray:
    """RBJ 2nd-order highpass, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(
        (1 + c) / 2, -(1 + c), (1 + c) / 2, 1 + alpha, -2 * c, 1 - alpha
    )


def design_bandpass(
    sample_rate: float, freq: float, q: float
) -> np.ndarray:
    """RBJ constant-0dB-peak bandpass, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    return _rbj_row(
        alpha, 0.0, -alpha, 1 + alpha, -2 * np.cos(w0), 1 - alpha
    )


def design_notch(sample_rate: float, freq: float, q: float) -> np.ndarray:
    """RBJ notch, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(1.0, -2 * c, 1.0, 1 + alpha, -2 * c, 1 - alpha)


def design_allpass(sample_rate: float, freq: float, q: float) -> np.ndarray:
    """RBJ allpass (unit magnitude, phase rotation), one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(
        1 - alpha, -2 * c, 1 + alpha, 1 + alpha, -2 * c, 1 - alpha
    )


def _design_shelf(
    sample_rate: float, freq: float, gain_db: float, slope: float, low: bool
) -> np.ndarray:
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * freq / sample_rate
    c = np.cos(w0)
    alpha = (
        np.sin(w0) / 2.0
        * np.sqrt((A + 1.0 / A) * (1.0 / slope - 1.0) + 2.0)
    )
    s2a = 2.0 * np.sqrt(A) * alpha
    p, m = A + 1, A - 1
    if low:
        return _rbj_row(
            A * ((p) - m * c + s2a), 2 * A * (m - p * c),
            A * (p - m * c - s2a),
            p + m * c + s2a, -2 * (m + p * c), p + m * c - s2a,
        )
    return _rbj_row(
        A * (p + m * c + s2a), -2 * A * (m + p * c),
        A * (p + m * c - s2a),
        p - m * c + s2a, 2 * (m - p * c), p - m * c - s2a,
    )


def design_lowshelf(
    sample_rate: float, freq: float, gain_db: float, slope: float = 1.0
) -> np.ndarray:
    """RBJ low shelf, one SOS row. ``slope=1`` is the steepest
    monotonic shelf."""
    return _design_shelf(sample_rate, freq, gain_db, slope, low=True)


def design_highshelf(
    sample_rate: float, freq: float, gain_db: float, slope: float = 1.0
) -> np.ndarray:
    """RBJ high shelf, one SOS row."""
    return _design_shelf(sample_rate, freq, gain_db, slope, low=False)
