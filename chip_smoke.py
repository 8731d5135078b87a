"""Smoke test of the streaming pipeline on NVIDIA GPUs.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the mesh path and its
                                     # one-device reference, nothing else

Phases on one card, all in this one process (a JAX process reserves most of
the card's memory, so there is one process per card):

  card tests  the tests marked ``chip`` (``tests/test_on_card.py``), run by
              pytest in a child process before this process touches JAX
  device      platform, device kind and count, nvidia-smi's name and power
              limit, JAX's version, whether the native library is live
  flagship    64 channels at 44.1 kHz through ``Pipe``: FIR(255) ->
              Resampler(48k/44.1k, 32 taps per phase) -> ChannelMix(2x64),
              10 s in 9,408-frame blocks, with and without ``optimize``
  live        the same line under live control: 50 gain pushes with no
              recompile, an ``at_block`` tap swap, an ``at_block`` biquad
              insert, and a checkpoint that resumes the stream exactly
  config4     OLSConvolve(65,536-tap IR) -> Biquad EQ, 16 channels,
              8,192-frame blocks, 4 s
  ops         every op and each streaming carry once, against the plain
              reference and the bound of its CPU test
  numerics    the flagship at every named matmul precision level, the
              check that every signal-path product is pinned to HIGHEST,
              and the double-f32 biquad on a 20 Hz section
  memory      peak device memory after the phases

Every comparison is against a float64 numpy/scipy reference. Each phase
prints one line; a failed phase prints FAIL and makes the script exit 1.
The last line of a run that passed is the JSON device record. The script
refuses to run without an NVIDIA GPU: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SR = 44100.0
SNR_LINEAR = 100.0  # dB: the bar for linear ops (tests/test_ops.py)
IIR_PATHS = ("assoc", "tiles")


class PhaseError(AssertionError):
    pass


# -- float64 references --------------------------------------------------------


def fir64(x64, h):
    """Causal FIR, float64, same length as the input."""
    import scipy.signal

    return scipy.signal.oaconvolve(x64, np.asarray(h)[None, :], axes=1)[
        :, : x64.shape[1]
    ]


def resample64(y64, up, down, taps_per_phase=32):
    """The polyphase resampler's exact float64 twin: upfirdn with the same
    prototype (``hp[p, i] = h[i*L + p]``), ceil(N*L/M) outputs."""
    import scipy.signal

    from pipe_tpu.ops.resample import _reduce_ratio, polyphase_design

    L, M = _reduce_ratio(up, down)
    h = polyphase_design(L, M, taps_per_phase).T.reshape(-1)
    n_out = -(-y64.shape[1] * L // M)
    return scipy.signal.upfirdn(h, y64, up=L, down=M, axis=1)[:, :n_out]


def check(results, name, ref, out, bound):
    """SNR of ``out`` against ``ref``; record it, fail below ``bound``."""
    from pipe_tpu.signal import snr_db

    ref = np.asarray(ref)
    out = np.asarray(out)
    if ref.shape != out.shape:
        raise PhaseError(f"{name}: shape {out.shape} != reference {ref.shape}")
    snr = float(snr_db(ref.astype(np.float64), out))
    results[name] = snr
    if not snr >= bound:
        raise PhaseError(f"{name}: {snr:.1f} dB < {bound} dB")
    return snr


def unpinned_products(lowered_text: str) -> list:
    """Dot and convolution ops of a lowered computation whose operands are
    not both at ``HIGHEST``: on the GPU an unpinned f32 product may run in
    TF32 (about three decimal digits)."""
    return [
        line.strip()[:120]
        for line in lowered_text.splitlines()
        if ("stablehlo.dot_general" in line or "stablehlo.convolution" in line)
        and line.count("HIGHEST") < 2
    ]


# -- host plumbing ---------------------------------------------------------------


def feed_source(x, sr=SR, gate=None, hold_at=0, short_reads=None):
    """A host-feed Source streaming ``x`` (C, N), then EOF. With ``gate``,
    the read at frame ``hold_at`` waits for it; with ``short_reads`` (a
    numpy Generator) every read returns a random 1..n frames."""
    from pipe_tpu.components import Source
    from pipe_tpu.signal import SignalProperties

    C, N = x.shape
    pos = [0]

    def feed(n):
        if gate is not None and pos[0] >= hold_at:
            if not gate.wait(600):
                raise RuntimeError("feed gate never opened")
        if pos[0] >= N:
            return None
        take = n if short_reads is None else int(short_reads.integers(1, n + 1))
        c = x[:, pos[0] : pos[0] + take]
        pos[0] += c.shape[1]
        return c

    return lambda ctx, block: Source(output=SignalProperties(sr, C), feed=feed)


def stream(procs, x, block, sr=SR, optimize=False):
    """Stream ``x`` through a Pipe of ``procs``; return the sink's (C, M)."""
    import pipe_tpu
    from pipe_tpu import mock

    sink = mock.Sink()
    p = pipe_tpu.Pipe(
        block,
        pipe_tpu.Line(source=feed_source(x, sr), processors=list(procs),
                      sink=sink.sink()),
        optimize=optimize,
    )
    p.start()
    p.wait(900)
    return sink.values


def wait_until(cond, what, timeout=600.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise PhaseError(f"timed out waiting for {what}")
        time.sleep(0.002)


# -- phases ----------------------------------------------------------------------


def phase_card_tests():
    """Run the ``chip``-marked tests on the card in a child pytest. Must
    run before this process touches JAX (the child needs the card's
    memory)."""
    env = dict(os.environ, PIPE_TPU_TESTS_ON_CHIP="1")
    cmd = [sys.executable, "-m", "pytest", "-q", "-m", "chip",
           "-p", "no:cacheprovider", "tests/test_on_card.py"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    if proc.returncode != 0 or "skipped" in summary or "passed" not in summary:
        sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-2000:])
        raise PhaseError(f"card tests: rc={proc.returncode} {summary!r}")
    return {"pytest": summary}


def phase_device(devices):
    from benchmarks import device
    from pipe_tpu import native

    import jax

    rec = device.device_record(devices)
    return {**rec, "jax": jax.__version__, "native": native.available()}


def phase_flagship(channels=64, seconds=10.0, block=9408, seed=0):
    from pipe_tpu import ops

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((channels, int(seconds * SR))).astype(np.float32)
    h = ops.design_lowpass(255, 4000.0, SR)
    mix = np.ones((2, channels), np.float32) / channels
    ref = mix.astype(np.float64) @ resample64(
        fir64(x.astype(np.float64), h), 48000, 44100
    )
    res = {}
    for optimize in (False, True):
        procs = [
            ops.FIR(h).processor(),
            ops.Resampler(48000, 44100, taps_per_phase=32).processor(),
            ops.ChannelMix(mix).processor(),
        ]
        t0 = time.perf_counter()
        y = stream(procs, x, block, optimize=optimize)
        res[f"s_optimize={optimize}"] = time.perf_counter() - t0
        check(res, f"snr_optimize={optimize}", ref, y, SNR_LINEAR)
    return res


def phase_live(channels=64, seconds=10.0, block=9408, seed=1):
    import pipe_tpu
    import scipy.signal
    from pipe_tpu import checkpoint, mock, ops

    rng = np.random.default_rng(seed)
    N = int(seconds * SR)
    x = rng.standard_normal((channels, N)).astype(np.float32)
    x64 = x.astype(np.float64)
    h1 = ops.design_lowpass(255, 4000.0, SR)
    h2 = ops.design_lowpass(255, 2000.0, SR)
    mix = np.ones((2, channels), np.float32) / channels
    mix64 = mix.astype(np.float64)
    peq = ops.design_peaking_eq(48000.0, 1000.0, 1.0, 3.0)
    bo = block * 160 // 147  # output frames per full block
    if block % 147:
        raise ValueError("block must be a multiple of 147")
    res = {}

    def line(src, procs, sink):
        return pipe_tpu.Line(source=src, processors=procs, sink=sink.sink())

    # 1. fifty gain pushes mid-stream: no recompile, the last one holds
    gate = threading.Event()
    gain = ops.Gain(1.0)
    sink = mock.Sink()
    p = pipe_tpu.Pipe(block, line(
        feed_source(x, gate=gate, hold_at=4 * block),
        [ops.FIR(h1).processor(), ops.Resampler(48000, 44100).processor(),
         gain.processor(), ops.ChannelMix(mix).processor()], sink))
    p.start()
    le = p._exec_of_route[0]
    wait_until(lambda: le.blocks_dispatched >= 4, "the first blocks")
    compiled = le.compile_counts()
    for i in range(50):
        p.push(gain.set_gain(1.0 - 0.01 * i))
    gate.set()
    p.wait(900)
    res["recompiles"] = le.compile_counts() - compiled
    if res["recompiles"]:
        raise PhaseError(f"50 gain pushes caused {res['recompiles']} compiles")
    ref = mix64 @ resample64(fir64(x64, h1), 48000, 44100)
    tail = 8 * bo
    check(res, "snr_gain_tail", 0.51 * ref[:, -tail:], sink.values[:, -tail:],
          SNR_LINEAR)

    # 2. at_block tap swap at block k, at_block biquad insert at block m,
    #    snapshot at block `half`, restore into a pipe built with the
    #    post-surgery graph, stream the rest
    k, m = 5, 12
    half = (N // block) // 2
    if not k < m < half:
        raise ValueError("stream too short for the live-control schedule")
    gate = threading.Event()
    fir = ops.FIR(h1)
    sink_a = mock.Sink()
    p = pipe_tpu.Pipe(block, line(
        feed_source(x[:, : half * block], gate=gate, hold_at=2 * block),
        [fir.processor(), ops.Resampler(48000, 44100).processor(),
         ops.ChannelMix(mix).processor()], sink_a))
    p.start()
    le = p._exec_of_route[0]
    p.push(fir.set_taps(h2), at_block=k)
    hd = p.insert_processor(
        0, 2, ops.Biquad(peq).processor(), at_block=m
    )
    wait_until(
        lambda: le._next_target(0) == k and le._next_target(k) == m,
        "both block targets to be queued",
    )
    gate.set()
    p.wait(900)
    if not (hd.wait(60) and hd.error is None):
        raise PhaseError(f"insert_processor failed: {hd.error!r}")
    ck = checkpoint.snapshot(p)
    sink_b = mock.Sink()
    p2 = pipe_tpu.Pipe(block, line(
        feed_source(x[:, half * block :]),
        [ops.FIR(h2).processor(), ops.Resampler(48000, 44100).processor(),
         ops.Biquad(peq).processor(), ops.ChannelMix(mix).processor()],
        sink_b))
    checkpoint.restore(p2, ck)
    p2.start()
    p2.wait(900)
    y = np.concatenate([sink_a.values, sink_b.values], axis=1)

    fir_out = fir64(x64, h1)
    fir_out[:, k * block :] = fir64(x64, h2)[:, k * block :]
    z = resample64(fir_out, 48000, 44100)
    z[:, m * bo :] = scipy.signal.sosfilt(peq[None, :], z[:, m * bo :], axis=1)
    ref = mix64 @ z
    for name, a, b in (("before_taps", 0, k * bo), ("taps", k * bo, m * bo),
                       ("insert", m * bo, half * bo),
                       ("restored", half * bo, ref.shape[1])):
        check(res, f"snr_{name}", ref[:, a:b], y[:, a:b], SNR_LINEAR)
    return res


def config4_ir(taps=65536, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(taps) * np.exp(-np.arange(taps) / 8000.0)


def phase_config4(channels=16, seconds=4.0, block=8192, ir_taps=65536, seed=3):
    import scipy.signal
    from pipe_tpu import ops

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((channels, int(seconds * SR))).astype(np.float32)
    ir = config4_ir(ir_taps)
    peq = ops.design_peaking_eq(SR, 1000.0, 1.0, 3.0)
    res = {}
    t0 = time.perf_counter()
    y = stream([ops.OLSConvolve(ir).processor(), ops.Biquad(peq).processor()],
               x, block)
    res["s"] = time.perf_counter() - t0
    ref = scipy.signal.sosfilt(
        peq[None, :], fir64(x.astype(np.float64), ir), axis=1
    )
    # tests/test_ops.py::test_ols_64k_ir_smoke: 90 dB for a 64k-tap IR
    # (its f32 partition accumulations); the EQ's refined recurrence sits
    # well above that
    check(res, "snr", ref, y, 90.0 if ir_taps > 8192 else SNR_LINEAR)
    return res


def _iir_reference(v, s, a1, a2):
    """y[n] = v[n] - a1 y[n-1] - a2 y[n-2] from state (y[-1], y[-2])."""
    import scipy.signal

    a = [1.0, float(a1), float(a2)]
    s = np.asarray(s, np.float64)
    zi = np.stack([scipy.signal.lfiltic([1.0], a, y=row) for row in s])
    return scipy.signal.lfilter([1.0], a, np.asarray(v, np.float64), axis=1,
                                zi=zi)[0]


def _envelope64(x, attack_ms, release_ms, sr=SR):
    """Sequential float64 envelope (release max-decay + attack one-pole)."""
    rc = np.exp(-1000.0 / (release_ms * sr))
    ac = np.exp(-1000.0 / (attack_ms * sr))
    xa = np.abs(x.astype(np.float64))
    env = np.zeros_like(xa)
    r = np.zeros(x.shape[0])
    e = np.zeros(x.shape[0])
    for n in range(x.shape[1]):
        r = np.maximum(xa[:, n], rc * r)
        e = ac * e + (1.0 - ac) * r
        env[:, n] = e
    return env


def phase_ops(channels=8, frames=16384, seed=4):
    """Each op through the streaming runtime against the float64 reference
    and the bound its CPU test uses (tests/test_ops.py, test_dynamics.py,
    test_spectral.py)."""
    import jax
    import jax.numpy as jnp
    import scipy.signal

    from pipe_tpu import ops
    from pipe_tpu.ops.biquad import _iir_apply
    from pipe_tpu.ops.channelizer import design_prototype, split_bins

    rng = np.random.default_rng(seed)
    C, N = channels, frames
    x = rng.standard_normal((C, N)).astype(np.float32)
    x64 = x.astype(np.float64)
    res = {}

    check(res, "gain", 0.25 * x64, stream([ops.Gain(0.25).processor()], x, 2048),
          120.0)
    m = rng.standard_normal((2, C)).astype(np.float32)
    check(res, "mix", m.astype(np.float64) @ x64,
          stream([ops.ChannelMix(m).processor()], x, 2048), SNR_LINEAR)
    h = ops.design_lowpass(255, 4000.0, SR)
    check(res, "fir", fir64(x64, h),
          stream([ops.FIR(h).processor()], x, 2048), SNR_LINEAR)
    for block in (2048, 147 * 14):  # gather path, supercycle-conv path
        check(res, f"resample_b{block}", resample64(x64, 160, 147),
              stream([ops.Resampler(160, 147).processor()], x, block),
              SNR_LINEAR)
    check(res, "fused", resample64(fir64(x64, h), 160, 147),
          stream([ops.FIRResampler(h, 160, 147).processor()], x, 147 * 14),
          SNR_LINEAR)
    ir = rng.standard_normal(2048) * np.exp(-np.arange(2048) / 300.0)
    check(res, "ols", fir64(x64, ir),
          stream([ops.OLSConvolve(ir).processor()], x, 2048), SNR_LINEAR)

    # the recurrence engines, each pinned, at a tile-eligible block
    sos = ops.design_peaking_eq(SR, 2000.0, 2.0, 6.0)
    a1, a2 = np.float32(sos[4]), np.float32(sos[5])
    Cv = max(16, C)
    v = rng.standard_normal((Cv, 8192)).astype(np.float32)
    s = rng.standard_normal((Cv, 2)).astype(np.float32)
    ref = _iir_reference(v, s, a1, a2)
    for path in IIR_PATHS:
        y = jax.jit(lambda v, s, path=path: _iir_apply(
            v, s, jnp.float32(a1), jnp.float32(a2), path))(v, s)
        check(res, f"iir_{path}", ref, np.asarray(y), 90.0)
    # the streaming biquad (refined) at an assoc block and a tiled block
    peq = ops.design_peaking_eq(SR, 1000.0, 10.0, 6.0)
    ref = scipy.signal.sosfilt(peq[None, :], x64, axis=1)
    for block in (256, 2048):
        check(res, f"biquad_b{block}", ref,
              stream([ops.Biquad(peq).processor()], x, block), SNR_LINEAR)

    # envelope + compressor (slow attack), tests/test_dynamics.py
    xc = (0.5 * x[:2]).astype(np.float32)
    env = _envelope64(xc, attack_ms=50.0, release_ms=120.0)
    over = np.maximum(20.0 * np.log10(np.maximum(env, 1e-8)) + 15.0, 0.0)
    g = 10.0 ** ((-over * (1.0 - 1.0 / 4.0)) / 20.0)
    check(res, "compressor", xc.astype(np.float64) * g, stream(
        [ops.Compressor(threshold_db=-15.0, ratio=4.0, attack_ms=50.0,
                        release_ms=120.0).processor()], xc, 1024), SNR_LINEAR)

    # channelizer at block 500 (the pend carry: 500 % 8 != 0) and 512,
    # against direct downconvert + filter + decimate per bin
    K = 8
    hp = design_prototype(K, 12)
    n = np.arange(N)
    Mo = N // K
    for block in (512, 500):
        Y = split_bins(stream([ops.Channelizer(K, taps_per_branch=12)
                               .processor()], x[:2], block), K)
        for k in range(K // 2 + 1):
            down = x64[:2] * np.exp(-2j * np.pi * k * n / K)[None, :]
            filt = np.stack([np.convolve(d, hp)[:N] for d in down])
            oracle = filt[:, ::K][:, :Mo]
            got = Y[:, k, :Mo]
            if got.shape != oracle.shape:
                raise PhaseError(f"channelizer_b{block}: {got.shape}")
            err = np.sum(np.abs(oracle - got) ** 2)
            snr = 10 * np.log10(np.sum(np.abs(oracle) ** 2) / max(err, 1e-300))
            res[f"channelizer_b{block}_bin{k}"] = snr
            if snr < SNR_LINEAR:
                raise PhaseError(f"channelizer_b{block} bin {k}: {snr:.1f} dB")

    # STFT at block 500 (the hop-residue carry: hop 256 does not divide it)
    W, H = 1024, 256
    y = stream([ops.SpectralGain(W, H).processor()], x[:2], 500)
    delayed = np.concatenate([np.zeros((2, W - H)), x64[:2]], axis=1)
    check(res, "stft_b500", delayed[:, : y.shape[1]], y, SNR_LINEAR)

    # oscillator: exact integer phase over a long stream
    no = 12 * N
    y = stream([ops.Oscillator(1000.0).processor()],
               np.ones((1, no), np.float32), 512, sr=8000.0)
    check(res, "oscillator",
          np.cos(2 * np.pi * 1000.0 * np.arange(no) / 8000.0)[None, :], y,
          SNR_LINEAR)

    # feedback delay with D > block (the block-ring carry)
    D, fb = 1234, 0.4
    y = stream([ops.Delay(D, feedback=fb, wet=0.5, dry=0.5).processor()],
               x[:1], 500)
    comb = scipy.signal.lfilter([1.0], np.r_[1.0, np.zeros(D - 1), -fb],
                                x64[:1], axis=1)
    tap = np.zeros_like(comb)
    tap[:, D:] = comb[:, :-D]
    check(res, "delay_ring_feedback", 0.5 * x64[:1] + 0.5 * tap, y, 110.0)
    return res


def _flagship_reference(channels, chunk, steps, seed):
    from pipe_tpu.flagship import FIR_TAPS, SAMPLE_RATE
    from pipe_tpu.ops import design_lowpass

    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((channels, chunk * steps)).astype(np.float32)
    h = design_lowpass(FIR_TAPS, 4000.0, SAMPLE_RATE)
    mix = np.ones((2, channels)) / channels
    return xs, mix @ resample64(fir64(xs.astype(np.float64), h), 160, 147)


def _run_chunks(fn, state, xs, chunk):
    import jax

    step = jax.jit(fn)
    outs = []
    for i in range(xs.shape[1] // chunk):
        state, y = step(state, xs[:, i * chunk : (i + 1) * chunk])
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


def phase_numerics(channels=64, chunk=147 * 256, steps=4, seed=5):
    import jax
    import scipy.signal

    from pipe_tpu import config, ops
    from pipe_tpu.flagship import make_flagship
    from pipe_tpu.ops.biquad import biquad_block, biquad_init_state
    from pipe_tpu.ops.ols import ols_block, ols_init_state, partition_ir

    res = {}
    xs, ref = _flagship_reference(channels, chunk, steps, seed)
    for level in config._NAMED:
        with config.matmul_precision_scope(level):
            fn, state, _ = make_flagship(channels=channels, chunk=chunk)
            y = _run_chunks(fn, state, xs, chunk)
        bound = SNR_LINEAR if level == "highest" else -np.inf
        check(res, f"snr_{level}", ref, y, bound)

    # every product on the signal path is pinned at the default level
    import jax.numpy as jnp

    lowered = []
    for fused in (True, False):
        fn, state, xe = make_flagship(channels=4, chunk=147 * 8, fused=fused)
        lowered.append(jax.jit(fn).lower(state, xe).as_text())
    block = 2048
    spec = jnp.asarray(partition_ir(config4_ir(8192), block))
    sos = jnp.asarray(ops.design_peaking_eq(SR, 1000.0, 1.0, 3.0)[None, :],
                      jnp.float32)

    def c4(state, x):
        f = jnp.asarray(block, jnp.int32)
        o, y = ols_block(state[0], x, f, spec)
        b, y = biquad_block(state[1], y, f, sos)
        return (o, b), y

    c4_state = (ols_init_state(16, block, spec.shape[1]),
                biquad_init_state(16, 1))
    lowered.append(jax.jit(c4).lower(
        c4_state, jnp.zeros((16, block), jnp.float32)).as_text())
    bad = [u for t in lowered for u in unpinned_products(t)]
    res["products"] = sum(
        t.count("stablehlo.dot_general") + t.count("stablehlo.convolution")
        for t in lowered)
    if bad:
        raise PhaseError(f"unpinned products: {bad[:3]}")

    # double-f32 biquad on a 20 Hz section (f32 floor ~72 dB there)
    rows = np.stack([ops.design_peaking_eq(SR, 20.0, 0.5, 6.0),
                     ops.design_peaking_eq(SR, 1000.0, 4.0, -4.0)])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    check(res, "snr_extended_20hz",
          scipy.signal.sosfilt(rows, x.astype(np.float64), axis=1),
          stream([ops.Biquad(rows, precision="extended").processor()], x, 512),
          SNR_LINEAR)
    return res


def phase_memory(devices):
    stats = devices[0].memory_stats() or {}
    return {"peak_bytes_in_use": stats.get("peak_bytes_in_use")}


# -- the mesh path (four cards) -------------------------------------------------


def _check_on_own_devices(arrays, mesh, what):
    """Every shard of every array lives on its own device of ``mesh``."""
    want = set(mesh.devices.flat)
    for a in arrays:
        shards = a.addressable_shards
        got = [s.device for s in shards]
        if set(got) != want:
            raise PhaseError(f"{what}: shards on {sorted(map(str, got))}")


def phase_mesh_chain(n_devices=4, channels=64, blocks=2048, steps=3, seed=6):
    """(a) ShardedChain FIR -> resample -> mix on 1xN and 2x(N/2) meshes
    vs the single-device flagship chunk function (``fused=False``)."""
    import jax

    from pipe_tpu import ops, parallel
    from pipe_tpu.flagship import make_flagship

    res = {}
    shapes = [(1, n_devices)]
    if n_devices % 2 == 0 and n_devices > 2:
        shapes.append((2, n_devices // 2))
    for ch, t in shapes:
        chunk = 147 * blocks * t
        rng = np.random.default_rng(seed)
        xs = rng.standard_normal((channels, chunk * steps)).astype(np.float32)
        fn, state, _ = make_flagship(channels=channels, chunk=chunk,
                                     fused=False)
        with jax.default_device(jax.devices()[0]):
            ref = _run_chunks(fn, state, xs, chunk)
        mesh = parallel.make_mesh(ch, t)
        chain = parallel.ShardedChain(
            mesh,
            [parallel.FIRStage(ops.design_lowpass(255, 4000.0, SR)),
             parallel.ResampleStage(48000, 44100, taps_per_phase=32),
             parallel.MixStage(np.ones((2, channels), np.float32) / channels)],
            channels=channels, chunk_frames=chunk,
        )
        y = chain.process(xs)
        _check_on_own_devices(jax.tree.leaves(chain.carries), mesh,
                              f"mesh {ch}x{t} carries")
        check(res, f"snr_{ch}x{t}", ref, y, SNR_LINEAR)
        xd = jax.device_put(xs[:, :chunk])
        jax.block_until_ready(chain.step(xd))
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            out = chain.step(xd)
        jax.block_until_ready(out)
        res[f"step_ms_{ch}x{t}"] = (time.perf_counter() - t0) / n * 1e3
    return res


def _mesh_line_procs(sharded, h, ir, sos, mix):
    """FIR -> OLS -> Biquad -> Resample -> Mix, as mesh (``sharded``) or
    streaming ops; returns (procs, fir)."""
    from pipe_tpu import ops, parallel

    if sharded:
        s = parallel.sharded
        fir = s.FIR(h)
        return [fir.processor(), s.OLS(ir).processor(),
                s.Biquad(sos).processor(),
                s.Resample(48000, 44100, taps_per_phase=32).processor(),
                s.Mix(mix).processor()], fir
    fir = ops.FIR(h)
    return [fir.processor(), ops.OLSConvolve(ir).processor(),
            ops.Biquad(sos).processor(),
            ops.Resampler(48000, 44100, taps_per_phase=32).processor(),
            ops.ChannelMix(mix).processor()], fir


def phase_mesh_pipe(n_devices=4, channels=64, n_local=9408, chunks=8,
                    ir_seconds=2.0, seed=7):
    """(b) A mesh Pipe (host feed with short reads, FIR -> distributed-FDL
    OLS -> Biquad -> Resample -> Mix, an at_block tap push and an at_block
    insert) vs the same line streamed on one device."""
    import jax

    import pipe_tpu
    from pipe_tpu import mock, ops, parallel

    ch = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    t = n_devices // ch
    mesh = parallel.make_mesh(ch, t)
    block = n_local * t
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((channels, block * chunks)).astype(np.float32)
    taps = int(ir_seconds * SR)
    ir = (rng.standard_normal(taps) * np.exp(-np.arange(taps) / (0.3 * SR)))
    ir = (ir / np.sqrt(np.sum(ir ** 2))).astype(np.float32)
    h = ops.design_lowpass(255, 4000.0, SR)
    h2 = ops.design_lowpass(255, 2500.0, SR)
    sos = ops.design_peaking_eq(SR, 1000.0, 1.0, 3.0)
    mix = np.ones((2, channels), np.float32) / channels
    k, m = 2, 5
    res = {"mesh": f"{ch}x{t}", "ir_taps": taps}

    def run(sharded):
        gate = threading.Event()
        procs, fir = _mesh_line_procs(sharded, h, ir, sos, mix)
        sink = mock.Sink()
        src = feed_source(x, gate=gate, hold_at=0,
                          short_reads=np.random.default_rng(42) if sharded
                          else None)
        p = pipe_tpu.Pipe(
            block,
            pipe_tpu.Line(source=src, processors=procs, sink=sink.sink()),
            mesh=mesh if sharded else None,
        )
        p.start()
        le = p._exec_of_route[0]
        p.push(fir.set_taps(h2), at_block=k)
        g = (parallel.sharded.Gain(0.5) if sharded else ops.Gain(0.5))
        hd = p.insert_processor(0, 3, g.processor(), at_block=m)
        wait_until(
            lambda: le._next_target(0) == k and le._next_target(k) == m,
            "both block targets to be queued",
        )
        gate.set()
        t0 = time.perf_counter()
        p.wait(900)
        dt = time.perf_counter() - t0
        if not (hd.wait(60) and hd.error is None):
            raise PhaseError(f"insert_processor failed: {hd.error!r}")
        if sharded:
            _check_on_own_devices(jax.tree.leaves(le._states()), mesh,
                                  "mesh pipe state")
        return sink.values, dt

    with jax.default_device(jax.devices()[0]):
        ref, res["s_one_device"] = run(False)
    y, res["s_mesh"] = run(True)
    check(res, "snr_vs_one_device", ref, y, SNR_LINEAR)
    return res


# -- driver ------------------------------------------------------------------------


def run_phase(name, fn, *args, **kw):
    t0 = time.perf_counter()
    try:
        res = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — reported, and fails the run
        import traceback

        traceback.print_exc()
        print(f"phase {name}: FAIL {type(e).__name__}: {e}"[:2000], flush=True)
        return False
    fields = " ".join(f"{k}={v}" for k, v in res.items())
    print(f"phase {name}: ok {time.perf_counter() - t0:.1f}s {fields}",
          flush=True)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the mesh path, on four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from benchmarks import device

    # fail before anything touches the card when there is no NVIDIA GPU
    card = device.card_name_and_power()
    ok = True
    if args.chips == 1:
        ok &= run_phase("card tests", phase_card_tests)

    device.enable_compile_cache()
    devices = device.require_gpu(args.chips)
    print(card, flush=True)
    ok &= run_phase("device", phase_device, devices)
    if args.chips == 1:
        ok &= run_phase("flagship", phase_flagship)
        ok &= run_phase("live", phase_live)
        ok &= run_phase("config4", phase_config4)
        ok &= run_phase("ops", phase_ops)
        ok &= run_phase("numerics", phase_numerics)
    else:
        ok &= run_phase("mesh chain", phase_mesh_chain, args.chips)
        ok &= run_phase("mesh pipe", phase_mesh_pipe, args.chips)
    ok &= run_phase("memory", phase_memory, devices)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": device.device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
