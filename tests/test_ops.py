"""DSP op golden tests — streaming output vs float64 scipy/numpy oracles.

This replaces the reference's reflect.DeepEqual bit-exactness (the rebuild
computes in f32 on the device) with SNR bounds: >= 100 dB for linear ops per
BASELINE.md, relaxed for IIR recursion (f32 pole feedback).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

import pipe_tpu
from pipe_tpu import mock, ops
from pipe_tpu.signal import Signal, snr_db

SNR_TARGET = 100.0


def stream_through(proc_allocs, x, block, sr=44100.0):
    """Push (C, N) float x through a line of processors; return (C, M)."""
    C, N = x.shape
    pos = [0]

    def feed(block_size):
        if pos[0] >= N:
            return None
        chunk = x[:, pos[0] : pos[0] + block_size]
        pos[0] += chunk.shape[1]
        return chunk

    def src_alloc(mctx, block_size):
        from pipe_tpu.components import Source
        from pipe_tpu.signal import SignalProperties

        return Source(
            output=SignalProperties(sample_rate=sr, channels=C), feed=feed
        )

    sink = mock.Sink()
    line = pipe_tpu.Line(
        source=src_alloc, processors=list(proc_allocs), sink=sink.sink()
    )
    pipe_tpu.run(block, line)
    return sink.values


# -- gain / mix ----------------------------------------------------------------

def test_gain_block():
    x = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    y = np.asarray(ops.gain_block(jnp.asarray(x), 0.5))
    np.testing.assert_allclose(y, 0.5 * x, rtol=1e-6)
    y2 = np.asarray(ops.gain_block(jnp.asarray(x), jnp.asarray([1.0, 2.0])))
    np.testing.assert_allclose(y2[1], 2.0 * x[1], rtol=1e-6)


def test_gain_processor_streaming(rng):
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    out = stream_through([ops.Gain(0.25).processor()], x, block=128)
    assert out.shape == (2, 1000)
    assert snr_db(0.25 * x.astype(np.float64), out) > 120


def test_channel_mix(rng):
    x = rng.standard_normal((4, 500)).astype(np.float32)
    m = rng.standard_normal((2, 4)).astype(np.float32)
    out = stream_through([ops.ChannelMix(m).processor()], x, block=128)
    oracle = m.astype(np.float64) @ x.astype(np.float64)
    assert out.shape == (2, 500)
    assert snr_db(oracle, out) > SNR_TARGET


def test_channel_mix_validates_channels():
    m = np.ones((2, 3), np.float32)
    x = np.zeros((4, 64), np.float32)
    with pytest.raises(pipe_tpu.AllocationError):
        stream_through([ops.ChannelMix(m).processor()], x, block=32)


# -- FIR -----------------------------------------------------------------------

def test_fir_streaming_matches_lfilter(rng):
    """Streamed 255-tap FIR == scipy.signal.lfilter on the whole signal."""
    h = ops.design_lowpass(255, cutoff=4000, sample_rate=44100)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    out = stream_through([ops.FIR(h).processor()], x, block=512)
    oracle = scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    assert out.shape == x.shape
    assert snr_db(oracle, out) > SNR_TARGET


def test_fir_partial_final_block(rng):
    h = ops.design_lowpass(63, cutoff=4000, sample_rate=44100)
    x = rng.standard_normal((1, 1000)).astype(np.float32)  # 1000 % 128 != 0
    out = stream_through([ops.FIR(h).processor()], x, block=128)
    oracle = scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    assert out.shape == (1, 1000)
    assert snr_db(oracle, out) > SNR_TARGET


def test_fir_per_channel_taps(rng):
    taps = rng.standard_normal((2, 31))
    x = rng.standard_normal((2, 512)).astype(np.float32)
    out = stream_through([ops.FIR(taps).processor()], x, block=64)
    for c in range(2):
        oracle = scipy.signal.lfilter(taps[c], [1.0], x[c].astype(np.float64))
        assert snr_db(oracle, out[c]) > SNR_TARGET


def test_fir_block_dynamic_frames(rng):
    """Mid-stream partial blocks advance the tail by `frames`, staying
    sample-exact vs the contiguous stream."""
    h = jnp.asarray(rng.standard_normal(17), jnp.float32)
    x_full = rng.standard_normal((1, 96)).astype(np.float32)
    fb = jax.jit(ops.fir_block)

    # contiguous: 2 blocks of 48
    tail = ops.fir_init_tail(1, 17)
    outs = []
    for i in range(2):
        tail, y = fb(tail, jnp.asarray(x_full[:, i * 48 : (i + 1) * 48]), 48, h)
        outs.append(np.asarray(y))
    ref = np.concatenate(outs, axis=1)

    # ragged: frames 48, 13, 35 in capacity-48 blocks
    tail = ops.fir_init_tail(1, 17)
    got = []
    cursor = 0
    for frames in (48, 13, 35):
        blk = np.zeros((1, 48), np.float32)
        blk[:, :frames] = x_full[:, cursor : cursor + frames]
        cursor += frames
        tail, y = fb(tail, jnp.asarray(blk), frames, h)
        got.append(np.asarray(y)[:, :frames])
    got = np.concatenate(got, axis=1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_fir_set_taps_mutation(rng):
    fir = ops.FIR(np.ones(9) / 9)
    x = rng.standard_normal((1, 256)).astype(np.float32)
    stream_through([fir.processor()], x, block=64)
    new = np.zeros(9)
    new[0] = 1.0
    fir.set_taps(new).apply()
    np.testing.assert_allclose(np.asarray(fir._component.params["taps"]), new)


# -- resampler -----------------------------------------------------------------

def _resample_oracle(x64, hp64, L, M):
    C, N = x64.shape
    K = hp64.shape[1]
    n_out = -(-N * L // M)
    j = np.arange(n_out)
    u = j * M
    p = u % L
    n0 = u // L
    ii = np.arange(K)
    nidx = n0[:, None] - ii[None, :]  # (n_out, K)
    valid = (nidx >= 0) & (nidx < N)
    xg = np.where(valid[None], x64[:, np.clip(nidx, 0, N - 1)], 0.0)
    return np.einsum("cok,ok->co", xg, hp64[p])


@pytest.mark.parametrize("up,down", [(160, 147), (147, 160), (2, 1)])
def test_resampler_vs_oracle(up, down, rng):
    r = ops.Resampler(up, down)
    hp64 = ops.polyphase_design(r.up, r.down, r.taps_per_phase)
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    out = stream_through([r.processor()], x, block=256)
    oracle = _resample_oracle(x.astype(np.float64), hp64, r.up, r.down)
    assert out.shape == oracle.shape
    assert snr_db(oracle, out) > SNR_TARGET


def test_resampler_441_to_48_sine_fidelity(rng):
    """A 1 kHz sine at 44.1k resampled to 48k must still be a clean 1 kHz
    sine (interior, away from filter edges)."""
    sr_in, sr_out = 44100, 48000
    n = 4410
    t = np.arange(n) / sr_in
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)[None, :]
    r = ops.Resampler(sr_out, sr_in)
    out = stream_through([r.processor()], x, block=441)
    # interior comparison against the ideal continuous-time sine
    delay = (r.taps_per_phase * r.up - 1) / 2 / r.up / sr_in  # group delay, s
    m = out.shape[1]
    tj = np.arange(m) / sr_out - delay
    ideal = np.sin(2 * np.pi * 1000.0 * tj)
    lo, hi = 200, m - 200
    assert snr_db(ideal[lo:hi], out[0, lo:hi]) > 80


def test_resampler_output_count():
    r = ops.Resampler(48000, 44100)
    assert (r.up, r.down) == (160, 147)
    x = np.zeros((1, 1470), np.float32)
    out = stream_through([r.processor()], x, block=147)
    assert out.shape[1] == 1600  # exact rational count


# -- overlap-save convolution ---------------------------------------------------

def test_ols_matches_direct_convolution(rng):
    ir = rng.standard_normal(2048) * np.exp(-np.arange(2048) / 300.0)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    out = stream_through([ops.OLSConvolve(ir).processor()], x, block=256)
    oracle = scipy.signal.lfilter(ir, [1.0], x.astype(np.float64), axis=1)
    assert out.shape == x.shape
    assert snr_db(oracle, out) > SNR_TARGET


def test_ols_per_channel_ir(rng):
    ir = rng.standard_normal((2, 500))
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    out = stream_through([ops.OLSConvolve(ir).processor()], x, block=128)
    for c in range(2):
        oracle = scipy.signal.lfilter(ir[c], [1.0], x[c].astype(np.float64))
        assert snr_db(oracle, out[c]) > SNR_TARGET


def test_ols_partial_final_block(rng):
    ir = rng.standard_normal(300)
    x = rng.standard_normal((1, 700)).astype(np.float32)
    out = stream_through([ops.OLSConvolve(ir).processor()], x, block=128)
    oracle = scipy.signal.lfilter(ir, [1.0], x.astype(np.float64), axis=1)
    assert out.shape == (1, 700)
    assert snr_db(oracle, out) > SNR_TARGET


@pytest.mark.slow
def test_ols_64k_ir_smoke(rng):
    """Benchmark-config-4 scale: 64k-tap IR, correctness on a short stream."""
    P = 65536
    ir = (rng.standard_normal(P) * np.exp(-np.arange(P) / 8000.0)).astype(
        np.float64
    )
    x = rng.standard_normal((1, 2048)).astype(np.float32)
    out = stream_through([ops.OLSConvolve(ir).processor()], x, block=512)
    oracle = scipy.signal.lfilter(ir, [1.0], x.astype(np.float64), axis=1)
    assert snr_db(oracle, out) > 90  # 128 f32 partition accumulations


# -- biquad EQ -----------------------------------------------------------------

def test_biquad_matches_sosfilt(rng):
    sos = ops.design_peaking_eq(44100, freq=1000, q=2.0, gain_db=6.0)
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    out = stream_through([ops.Biquad(sos).processor()], x, block=256)
    oracle = scipy.signal.sosfilt(sos[None, :], x.astype(np.float64), axis=1)
    assert out.shape == x.shape
    assert snr_db(oracle, out) > 80  # f32 recursion bound


def test_biquad_cascade(rng):
    sos = np.stack(
        [
            ops.design_peaking_eq(44100, 500, 1.0, 3.0),
            ops.design_peaking_eq(44100, 4000, 2.0, -6.0),
        ]
    )
    x = rng.standard_normal((1, 1024)).astype(np.float32)
    out = stream_through([ops.Biquad(sos).processor()], x, block=128)
    oracle = scipy.signal.sosfilt(sos, x.astype(np.float64), axis=1)
    assert snr_db(oracle, out) > 75


def test_biquad_streaming_continuity(rng):
    """Block-streamed == one-shot (state carry across blocks is exact)."""
    sos = ops.design_peaking_eq(44100, 2000, 1.5, 4.0)
    x = rng.standard_normal((1, 512)).astype(np.float32)
    out_small = stream_through([ops.Biquad(sos).processor()], x, block=64)
    out_big = stream_through([ops.Biquad(sos).processor()], x, block=512)
    assert snr_db(out_big.astype(np.float64), out_small) > 110


# -- oscillator / demod ---------------------------------------------------------

def test_oscillator_phase_exact_long_stream():
    """Exact integer phase: SNR vs float64 oracle stays high even after
    hundreds of thousands of samples (naive f32 sin(2*pi*f*t) decays)."""
    sr, f = 8000, 1000.0
    n = 200_000
    x = np.ones((1, n), np.float32)
    out = stream_through([ops.Oscillator(f).processor()], x, block=512, sr=sr)
    oracle = np.cos(2 * np.pi * f * np.arange(n, dtype=np.float64) / sr)
    assert snr_db(oracle, out[0]) > SNR_TARGET


def test_am_demod_recovers_message(rng):
    """Coherent AM demod: carrier 1 kHz @ 8 kHz, 50 Hz message."""
    sr = 8000
    n = 8000
    t = np.arange(n, dtype=np.float64) / sr
    msg = 0.5 + 0.5 * np.sin(2 * np.pi * 50.0 * t)
    x = (msg * np.cos(2 * np.pi * 1000.0 * t)).astype(np.float32)[None, :]
    lp = ops.design_lowpass(255, cutoff=200, sample_rate=sr)
    chain = ops.am_demod_factory(1000.0, lp)
    out = stream_through(chain, x, block=512, sr=sr)
    assert out.shape == (1, n)
    delay = 127  # lowpass group delay
    interior = out[0, 1000:-1000]
    oracle = msg[1000 - delay : n - 1000 - delay] / 2.0
    assert snr_db(oracle, interior) > 40  # envelope after 255-tap lowpass


def test_fir_matmul_pad_path(rng):
    """A block size that is not a multiple of the frame size takes the
    padded Toeplitz path."""
    from pipe_tpu.ops.fir import _FRAME

    h = ops.design_lowpass(255, cutoff=4000, sample_rate=44100)
    block = 5 * _FRAME + 16
    x = rng.standard_normal((2, block * 6)).astype(np.float32)
    out = stream_through([ops.FIR(h).processor()], x, block=block)
    oracle = scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    assert snr_db(oracle, out) > SNR_TARGET


def test_resampler_fast_path_equals_gather_path(rng):
    """The same stream through a divisible block size (supercycle-matmul
    fast path) and an indivisible one (gather path) must agree to f32
    rounding: the two formulations are the same filter bank."""
    x = rng.standard_normal((2, 147 * 16)).astype(np.float32)
    r1 = ops.Resampler(48000, 44100)
    r2 = ops.Resampler(48000, 44100)
    fast = stream_through([r1.processor()], x, block=294)  # 2*147: fast path
    slow = stream_through([r2.processor()], x, block=100)  # gather path
    n = min(fast.shape[1], slow.shape[1])
    assert n >= 147 * 16 * 160 // 147 - 160
    assert snr_db(slow[:, :n].astype(np.float64), fast[:, :n]) > 120


def test_iir_tiled_paths_match_assoc(rng):
    """The tiled Toeplitz recurrence (scan of tile matmuls) must match the
    associative-scan path and sosfilt."""
    from pipe_tpu.ops.biquad import _iir_apply

    sos = ops.design_peaking_eq(44100, freq=2000, q=2.0, gain_db=6.0)
    a1, a2 = jnp.float32(sos[4]), jnp.float32(sos[5])
    C, B = 8, 4096
    v = jnp.asarray(rng.standard_normal((C, B)), jnp.float32)
    s = jnp.asarray(rng.standard_normal((C, 2)), jnp.float32)

    y_assoc = np.asarray(jax.jit(lambda: _iir_apply(v, s, a1, a2, "assoc"))())
    y_tiles = np.asarray(jax.jit(lambda: _iir_apply(v, s, a1, a2, "tiles"))())
    assert snr_db(y_assoc.astype(np.float64), y_tiles) > 110

    # absolute truth: pure-python recurrence in float64
    ref = np.zeros((C, B))
    y1, y2 = np.asarray(s[:, 0], np.float64), np.asarray(s[:, 1], np.float64)
    vv = np.asarray(v, np.float64)
    for n in range(B):
        yn = vv[:, n] - float(a1) * y1 - float(a2) * y2
        ref[:, n] = yn
        y1, y2 = yn, y1
    assert snr_db(ref, y_tiles) > 90  # f32 pole feedback bound


@pytest.mark.parametrize(
    "B,backend,path",
    [
        (8192, "gpu", "assoc"),  # the GPU always scans (H100 timings)
        (256, "gpu", "assoc"),
        (8192, "cpu", "tiles"),
        (2048, "cpu", "tiles"),
        (1024, "cpu", "assoc"),  # under _TILE_MIN_B
        (2304, "cpu", "tiles"),
        (2100, "cpu", "assoc"),  # not whole tiles
    ],
)
def test_iir_dispatch_rule(B, backend, path):
    from pipe_tpu.ops.biquad import _iir_path

    assert _iir_path(B, backend) == path


def test_iir_dispatch_follows_default_backend():
    from pipe_tpu.ops.biquad import _iir_path

    assert jax.default_backend() == "cpu"
    assert _iir_path(8192) == "tiles"


def test_biquad_large_block_tiled_streaming(rng):
    """Streaming biquad at a tile-eligible block size stays continuous and
    matches sosfilt (exercises the dispatch into the tiled path on CPU)."""
    sos = ops.design_peaking_eq(44100, freq=500, q=1.0, gain_db=-4.0)
    x = rng.standard_normal((8, 8192)).astype(np.float32)
    out = stream_through([ops.Biquad(sos).processor()], x, block=2048)
    ref = scipy.signal.sosfilt(sos[None, :], x.astype(np.float64), axis=1)
    assert snr_db(ref, out) > 90


def test_biquad_refined_high_q_100db(rng):
    """Iterative refinement clears 100 dB on a |pole|~=0.995 peaking EQ
    against the float64 oracle — the IIR precision bar the plain f32
    recurrence misses (~80-90 dB). Both the small-block (assoc scan) and
    tile-eligible block sizes are checked."""
    sos = ops.design_peaking_eq(44100, freq=1000, q=10.0, gain_db=6.0)
    pole = np.sqrt(sos[5])
    assert pole >= 0.9949, pole
    x = rng.standard_normal((8, 16384)).astype(np.float32)
    ref = scipy.signal.sosfilt(sos[None, :], x.astype(np.float64), axis=1)
    for block in (256, 2048):
        out = stream_through([ops.Biquad(sos).processor()], x, block=block)
        snr = snr_db(ref, out)
        assert snr > 100, f"block={block}: {snr:.1f} dB"
    # refine=False keeps the fast single-pass path available
    out = stream_through(
        [ops.Biquad(sos, refine=False).processor()], x, block=256
    )
    assert snr_db(ref, out) > 70


def test_dd_transforms_exact_under_jit(rng):
    """The extended-precision engine's error-free transforms must capture
    rounding errors EXACTLY under jit. This is non-trivial: XLA:CPU's LLVM
    backend contracts mul+add chains into fma, which silently changes the
    rounding the transforms rely on (ops/biquad.py::_opaque_one documents
    the counter-measure). A regression here degrades Biquad
    precision='extended' from ~150 dB back to the f32 kappa floor."""
    from pipe_tpu.ops.biquad import _opaque_one, _two_prod, _two_sum

    a = jnp.asarray(rng.standard_normal(4096).astype(np.float32))
    b = jnp.asarray(rng.standard_normal(4096).astype(np.float32))

    def probe(a, b):
        one = _opaque_one(a[0])
        s, e = _two_sum(a, b)
        p, f = _two_prod(a, b, one)
        return s, e, p, f

    s, e, p, f = jax.jit(probe)(a, b)
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    s64 = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    p64 = np.asarray(p, np.float64) + np.asarray(f, np.float64)
    np.testing.assert_array_equal(s64, a64 + b64)
    np.testing.assert_array_equal(p64, a64 * b64)


def test_biquad_extended_precision_breaks_kappa_floor(rng):
    """precision='extended' (double-f32 recurrence) must beat the f32
    noise-gain cap documented in docs/PERF_NOTES.md: a 20 Hz q=0.5 section
    at 44.1 kHz has kappa*2^-24 floor ~72 dB — the refined f32 engine
    CANNOT reach 100 dB there by design, the extended engine must. The
    cascade also carries a 1 kHz section so inter-section rounding is
    exercised, and the stream crosses 31 block boundaries with a partial
    final block."""
    rows = np.stack([
        ops.design_peaking_eq(44100, 20.0, 0.5, 6.0),
        ops.design_peaking_eq(44100, 1000.0, 4.0, -4.0),
    ])
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    ref = scipy.signal.sosfilt(rows, x.astype(np.float64), axis=1)
    out = stream_through(
        [ops.Biquad(rows, precision="extended").processor()], x, block=512
    )
    snr = snr_db(ref, out)
    assert snr > 100, f"{snr:.1f} dB"
    # the standard engine on the same chain sits under its documented floor
    out_std = stream_through([ops.Biquad(rows).processor()], x, block=512)
    assert snr_db(ref, out_std) < 100


# -- fused FIR + resampler -----------------------------------------------------


def test_fused_fir_resampler_matches_sequential(rng):
    """FIRResampler output == FIR then Resampler, streamed (fusion identity)."""
    C, N, block = 2, 147 * 30, 588
    x = rng.standard_normal((C, N)).astype(np.float32)
    h = ops.design_lowpass(255, 4000.0, 44100.0)

    fir = ops.FIR(h)
    rs = ops.Resampler(160, 147)
    y_seq = stream_through([fir.processor(), rs.processor()], x, block)

    fused = ops.FIRResampler(h, 160, 147)
    y_fused = stream_through([fused.processor()], x, block)

    assert y_fused.shape == y_seq.shape
    assert snr_db(y_seq, y_fused) >= SNR_TARGET


def test_fused_fir_resampler_output_rate():
    fused = ops.FIRResampler(ops.design_lowpass(31, 4000.0, 44100.0), 48000, 44100)
    alloc = fused.processor()
    from pipe_tpu import mutable
    from pipe_tpu.signal import SignalProperties

    comp = alloc(mutable.mutable(), 588, SignalProperties(44100.0, 2))
    assert comp.output.sample_rate == pytest.approx(48000.0)


def test_fused_set_taps_mutation_no_retrace(rng):
    """Mutating the FIR taps of the fused stage changes output without
    recompiling (params are traced inputs)."""
    C, N, block = 1, 147 * 20, 147 * 4
    x = rng.standard_normal((C, N)).astype(np.float32)
    h1 = ops.design_lowpass(63, 4000.0, 44100.0)
    h2 = ops.design_lowpass(63, 1000.0, 44100.0)

    fused = ops.FIRResampler(h1, 160, 147)
    alloc = fused.processor()
    from pipe_tpu import mutable
    from pipe_tpu.signal import SignalProperties

    mctx = mutable.mutable()
    comp = alloc(mctx, block, SignalProperties(44100.0, C))

    traces = [0]
    base_step = comp.step

    def counting_step(state, params, sig):
        traces[0] += 1
        return base_step(state, params, sig)

    step = jax.jit(counting_step)
    st = comp.state
    sig = Signal(jnp.asarray(x[:, :block]), jnp.asarray(block, jnp.int32))
    st, out1 = step(st, comp.params, sig)
    n_traces = traces[0]

    fused.set_taps(h2).apply()
    st, out2 = step(st, comp.params, sig)
    assert traces[0] == n_traces  # no retrace on mutation
    assert not np.allclose(np.asarray(out1.data), np.asarray(out2.data))


def test_optimize_fuse_line(rng):
    """pipe_tpu.optimize.fuse collapses FIR+Resampler; output matches the
    unfused line and set_taps on the ORIGINAL object still mutates."""
    C, N, block = 1, 147 * 30, 588
    x = rng.standard_normal((C, N)).astype(np.float32)
    h = ops.design_lowpass(101, 4000.0, 44100.0)

    y_plain = stream_through(
        [ops.FIR(h).processor(), ops.Resampler(160, 147).processor()], x, block
    )

    fir = ops.FIR(h)
    rs = ops.Resampler(160, 147)
    gain = ops.Gain(1.0)
    line_procs = [fir.processor(), rs.processor(), gain.processor()]

    import pipe_tpu.optimize
    from pipe_tpu.graph import Line as _Line

    line = _Line(source=None, sink=None, processors=line_procs)
    fused_line = pipe_tpu.optimize.fuse(line)
    assert len(fused_line.processors) == 2  # fused + gain

    y_fused = stream_through(fused_line.processors, x, block)
    assert snr_db(y_plain, y_fused) >= SNR_TARGET

    # mutation path is delegated to the fused component
    m = fir.set_taps(ops.design_lowpass(101, 1000.0, 44100.0))
    assert m is not None


# -- polyphase channelizer -----------------------------------------------------


def test_channelizer_matches_direct_oracle(rng):
    """Bank output == direct downconvert+filter+decimate in float64."""
    from pipe_tpu.ops.channelizer import (
        Channelizer, design_prototype, split_bins,
    )

    K, C, block = 8, 2, 512
    N = block * 6
    x = rng.standard_normal((C, N)).astype(np.float32)
    ch = Channelizer(K, taps_per_branch=12)
    y = stream_through([ch.processor()], x, block)
    Y = split_bins(y, K)  # (C, K//2+1, M)

    h = design_prototype(K, 12)
    xf = np.asarray(x, np.float64)
    M = N // K
    n = np.arange(N)
    for k in range(K // 2 + 1):
        down = xf * np.exp(-2j * np.pi * k * n / K)[None, :]
        filt = np.stack([np.convolve(down[c], h)[:N] for c in range(C)])
        # y_k[m] = sum_n x[n] h[mK - n] e^{-jwkn} = (h * down)[mK]
        oracle = filt[:, ::K][:, :M]
        got = Y[:, k, :M]
        err = oracle - got
        s = 10 * np.log10(
            max(np.sum(np.abs(oracle) ** 2), 1e-300)
            / max(np.sum(np.abs(err) ** 2), 1e-300)
        )
        assert s >= 100, f"bin {k}: {s:.1f} dB"


def test_channelizer_sine_lands_in_one_bin(rng):
    """A tone at bin-3 center shows up in bin 3 and nowhere else."""
    from pipe_tpu.ops.channelizer import Channelizer, split_bins

    K, block = 16, 512
    N = block * 8
    sr = 44100.0
    t = np.arange(N)
    tone = np.cos(2 * np.pi * (3.0 / K) * t).astype(np.float32)[None, :]
    ch = Channelizer(K)
    y = stream_through([ch.processor()], tone, block, sr=sr)
    Y = split_bins(y, K)
    power = np.mean(np.abs(Y[0]) ** 2, axis=1)
    settle = Y.shape[2] // 4
    power = np.mean(np.abs(Y[0, :, settle:]) ** 2, axis=1)
    assert np.argmax(power) == 3
    others = np.delete(power, 3)
    assert power[3] > 1e4 * others.max()  # > 40 dB isolation


def test_channelizer_any_block_size(rng):
    """r4: a block size that is NOT a multiple of K streams exactly — the
    pend carry absorbs the residue; output groups emit as they complete
    (formerly a build error)."""
    K = 8
    x = rng.standard_normal((1, 8000)).astype(np.float32)
    ref = stream_through([ops.Channelizer(K).processor()], x, 512)
    got = stream_through([ops.Channelizer(K).processor()], x, 500)
    n = min(ref.shape[1], got.shape[1])
    assert n >= 8000 // K - 1
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=2e-5)


def test_fm_demod_recovers_message(rng):
    """FM modulate in float64, demodulate with the IQ->FIR->discriminator
    chain; the recovered instantaneous frequency tracks the message."""
    sr = 44100.0
    fc = 8000.0
    dev = 1500.0  # Hz deviation
    N = 44100
    t = np.arange(N) / sr
    msg = np.sin(2 * np.pi * 40.0 * t)  # 40 Hz message
    phase = 2 * np.pi * fc * t + 2 * np.pi * dev * np.cumsum(msg) / sr
    x = np.cos(phase).astype(np.float32)[None, :]

    chain = ops.fm_demod_factory(fc, ops.design_lowpass(255, 3000.0, sr))
    y = stream_through(chain, x, 512)  # cycles/sample deviation
    got_hz = y[0] * sr

    settle = 2000
    expect = dev * msg
    # compare interior, compensating the lowpass FIR's (255-1)/2-sample
    # group delay (filter transients trimmed at both ends)
    gd = 127
    g = got_hz[settle + gd : -settle + gd]
    e = expect[settle:-settle]
    corr = np.corrcoef(g, e)[0, 1]
    assert corr > 0.999
    assert np.abs(np.max(g) - dev) < dev * 0.05


def test_channelizer_midstream_partial_blocks(rng):
    """Irregular mid-stream chunk sizes (frames % K != 0) must produce the
    same subband stream as contiguous feeding — the pending-sample phase
    state keeps polyphase alignment exact."""
    from pipe_tpu.ops.channelizer import Channelizer, split_bins
    import pipe_tpu
    from pipe_tpu import mock
    from pipe_tpu.components import Source
    from pipe_tpu.signal import SignalProperties

    K, C, block = 8, 1, 64
    N = 64 * 40
    x = rng.standard_normal((C, N)).astype(np.float32)

    def run_with_chunks(chunks):
        pos = [0]
        it = iter(chunks)

        def feed(bs):
            if pos[0] >= N:
                return None
            n = min(next(it, bs), N - pos[0], bs)
            c = x[:, pos[0] : pos[0] + n]
            pos[0] += n
            return c

        def src_alloc(mctx, bs):
            return Source(output=SignalProperties(44100.0, C), feed=feed)

        sink = mock.Sink()
        ch = Channelizer(K, taps_per_branch=8)
        line = pipe_tpu.Line(
            source=src_alloc, processors=[ch.processor()], sink=sink.sink()
        )
        pipe_tpu.run(block, line)
        return split_bins(sink.values, K)

    ref = run_with_chunks(iter(lambda: 64, 0))  # always-full blocks
    # ragged: 36, 17, 50, 64, 3, ... (never aligned to K)
    ragged_sizes = [36, 17, 50, 64, 3, 29, 61, 44] * 20
    got = run_with_chunks(ragged_sizes)

    M = min(ref.shape[2], got.shape[2])
    err = np.abs(ref[:, :, :M] - got[:, :, :M]).max()
    assert ref.shape[2] - got.shape[2] <= 1  # at most one trailing group held
    assert err < 1e-6, err


def test_rbj_cookbook_designers(rng):
    """Every RBJ designer's frequency response matches its defining
    magnitude behavior (float64 freqz oracle), and the rows stream through
    Biquad at >100 dB vs sosfilt."""
    sr = 44100.0

    def mag(sos, f):
        w, h = scipy.signal.sosfreqz(sos[None, :], worN=[2 * np.pi * f / sr])
        return float(np.abs(h[0]))

    lp = ops.design_lowpass_biquad(sr, 1000.0)
    assert mag(lp, 20.0) == pytest.approx(1.0, abs=1e-3)
    assert mag(lp, 1000.0) == pytest.approx(0.7071, abs=2e-3)
    assert mag(lp, 10000.0) < 0.02

    hp = ops.design_highpass_biquad(sr, 1000.0)
    assert mag(hp, 20000.0) == pytest.approx(1.0, abs=2e-2)
    assert mag(hp, 100.0) < 0.02

    bp = ops.design_bandpass(sr, 2000.0, q=4.0)
    assert mag(bp, 2000.0) == pytest.approx(1.0, abs=1e-3)
    assert mag(bp, 200.0) < 0.05 and mag(bp, 20000.0) < 0.05

    nt = ops.design_notch(sr, 2000.0, q=4.0)
    assert mag(nt, 2000.0) < 1e-6
    assert mag(nt, 100.0) == pytest.approx(1.0, abs=1e-2)

    ap = ops.design_allpass(sr, 2000.0, q=1.0)
    for f in (100.0, 2000.0, 15000.0):
        assert mag(ap, f) == pytest.approx(1.0, abs=1e-6)

    ls = ops.design_lowshelf(sr, 500.0, gain_db=6.0)
    assert 20 * np.log10(mag(ls, 20.0)) == pytest.approx(6.0, abs=0.1)
    assert mag(ls, 20000.0) == pytest.approx(1.0, abs=1e-2)

    hsh = ops.design_highshelf(sr, 5000.0, gain_db=-9.0)
    assert 20 * np.log10(mag(hsh, 20000.0)) == pytest.approx(-9.0, abs=0.2)
    assert mag(hsh, 50.0) == pytest.approx(1.0, abs=1e-2)

    # a designed cascade streamed through Biquad vs the float64 oracle
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    out = stream_through([ops.Biquad(np.stack([ls, hsh, ap])).processor()], x, block=512)
    oracle = scipy.signal.sosfilt(np.stack([ls, hsh, ap]), x.astype(np.float64), axis=1)
    assert snr_db(oracle, out) > 100
