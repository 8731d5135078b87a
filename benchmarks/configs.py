"""BASELINE.md benchmark configs 1-5, one JSON line each.

Run on a GPU: ``python benchmarks/configs.py [config ...]`` (refuses the
CPU; prints the device lines first).

1. single-line passthrough: mock source -> gain -> sink, 512-frame blocks
2. stereo gain+mix chain, mutable gain pushed mid-stream (measures that a
   push costs a block boundary, not a recompile)
3. FIR lowpass (255-tap) + polyphase resample 44.1k->48k, 8 channels
4. FFT overlap-save convolution reverb (64k-tap IR) + EQ chain, 16 channels
5. 64-channel chain on a (channel x time) mesh — sharding validated on
   however many devices are visible (1 on a single chip; the dryrun
   entry point covers 8-way on CPU)

Configs 1-2 run through the *streaming runtime* (block dispatch latency is
the product), 3-5 through device-resident chunk steps (throughput is the
product).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


#: set True (bench.py does) to suppress per-config stdout lines — the
#: driver contract is ONE JSON line from bench.py, which embeds these
#: records in its "configs" field instead
QUIET = False


def _emit(name, samples, seconds, note="", **extra):
    rec = {
        "config": name,
        "samples_per_s": samples / seconds,
        "seconds": seconds,
        "note": note,
        **extra,
    }
    if not QUIET:
        print(json.dumps(rec), flush=True)
    return rec


def config1():
    """Streaming runtime dispatch: mock -> gain -> discard sink."""
    import pipe_tpu
    from pipe_tpu import mock, ops

    blocks, block = 2000, 512
    src = mock.Source(value=1.0, channels=1, limit=blocks * block)
    sink = mock.Sink(discard=True)
    g = ops.Gain(0.5)
    line = pipe_tpu.Line(
        source=src.source(), sink=sink.sink(), processors=[g.processor()]
    )
    pipe_tpu.run(block, line, lookahead=32)  # warm the compile cache
    src2 = mock.Source(value=1.0, channels=1, limit=blocks * block)
    sink2 = mock.Sink(discard=True)
    line2 = pipe_tpu.Line(
        source=src2.source(), sink=sink2.sink(), processors=[ops.Gain(0.5).processor()]
    )
    t0 = time.perf_counter()
    pipe_tpu.run(block, line2, lookahead=32)
    dt = time.perf_counter() - t0
    recs = [_emit(
        "1_passthrough_gain_512", blocks * block, dt,
        f"{dt/blocks*1e6:.0f} us/block dispatch, lookahead 32",
        us_per_block=dt / blocks * 1e6,
    )]

    # batched variant: one lax.scan dispatch per 32 blocks
    for k in (32,):
        srcb = mock.Source(value=1.0, channels=1, limit=blocks * block)
        sinkb = mock.Sink(discard=True)
        lineb = pipe_tpu.Line(
            source=srcb.source(), sink=sinkb.sink(),
            processors=[ops.Gain(0.5).processor()],
        )
        pipe_tpu.run(block, lineb, lookahead=32, batch_blocks=k)  # warm
        srcb = mock.Source(value=1.0, channels=1, limit=blocks * block)
        sinkb = mock.Sink(discard=True)
        lineb = pipe_tpu.Line(
            source=srcb.source(), sink=sinkb.sink(),
            processors=[ops.Gain(0.5).processor()],
        )
        t0 = time.perf_counter()
        pipe_tpu.run(block, lineb, lookahead=32, batch_blocks=k)
        dt = time.perf_counter() - t0
        recs.append(_emit(
            "1b_passthrough_gain_512_batched", blocks * block, dt,
            f"{dt/blocks*1e6:.0f} us/block, batch_blocks {k}",
            us_per_block=dt / blocks * 1e6,
        ))
    return recs


def config2():
    """Mutation push cost: stereo gain+mix with a mid-stream gain push."""
    import pipe_tpu
    from pipe_tpu import mock, ops

    blocks, block = 1000, 512
    src = mock.Source(value=1.0, channels=2, limit=blocks * block)
    sink = mock.Sink(discard=True)
    g = ops.Gain(1.0)
    mx = ops.ChannelMix(np.eye(2, dtype=np.float32))
    p = pipe_tpu.Pipe(
        block,
        pipe_tpu.Line(
            source=src.source(),
            sink=sink.sink(),
            processors=[g.processor(), mx.processor()],
        ),
        lookahead=32,
    )
    t0 = time.perf_counter()
    p.start()
    le = p._exec_of_route[0]
    while le.blocks_dispatched < 4:
        time.sleep(0.002)  # let the step compile before counting
    compiled_before = le.compile_counts()
    for i in range(50):  # 50 pushes mid-stream: none may recompile
        p.push(g.set_gain(1.0 - i * 0.01))
    p.wait(600)
    dt = time.perf_counter() - t0
    recompiles = le.compile_counts() - compiled_before
    return [_emit(
        "2_stereo_gain_mix_mutated", blocks * block * 2, dt,
        f"50 live pushes, {recompiles} recompiles",
        recompiles=recompiles,
    )]


def _chunk_bench(name, fn, state, x, in_samples_per_step, steps=64, note=""):
    """Seconds per step of ``fn`` chained through its donated state, ended
    by ``jax.block_until_ready``."""
    step = jax.jit(fn, donate_argnums=(0,))
    state = jax.device_put(state)
    x = jax.device_put(x)
    for _ in range(3):
        state, y = step(state, x)
    jax.block_until_ready((state, y))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, y = step(state, x)
    jax.block_until_ready((state, y))
    dt = (time.perf_counter() - t0) / steps
    return _emit(name, in_samples_per_step, dt, note)


def config3():
    """FIR 255 + resample, 8 channels, device-resident chunks."""
    from pipe_tpu import ops
    from pipe_tpu.ops.fir import fir_apply
    from pipe_tpu.ops.resample import resample_apply, polyphase_design

    C, chunk = 8, 147 * 2048
    h = jnp.asarray(ops.design_lowpass(255, 4000, 44100), jnp.float32)
    hp = jnp.asarray(polyphase_design(160, 147, 32), jnp.float32)

    def fn(state, x):
        tail, hist = state
        y = fir_apply(tail, x, h)
        z = resample_apply(hist, y, hp, 160, 147)
        return (x[:, -254:], y[:, -31:]), z

    state = (jnp.zeros((C, 254), jnp.float32), jnp.zeros((C, 31), jnp.float32))
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((C, chunk)), jnp.float32
    )
    return [_chunk_bench("3_fir255_resample_8ch", fn, state, x, C * chunk)]


def config4():
    """64k-tap OLS reverb + peaking EQ, 16 channels."""
    from pipe_tpu import ops
    from pipe_tpu.ops.ols import ols_block, ols_init_state, partition_ir
    from pipe_tpu.ops.biquad import biquad_block, biquad_init_state

    C, block = 16, 8192
    rng = np.random.default_rng(1)
    ir = (rng.standard_normal(65536) * np.exp(-np.arange(65536) / 8000)).astype(
        np.float64
    )
    spec = jnp.asarray(partition_ir(ir, block))
    sos = jnp.asarray(
        np.asarray(
            ops.design_peaking_eq(44100, freq=1000, q=1.0, gain_db=3.0)[None, :],
            np.float32,
        )
    )

    def fn(state, x):
        ols_state, bq_state = state
        frames = jnp.asarray(block, jnp.int32)
        ols_state, y = ols_block(ols_state, x, frames, spec)
        bq_state, y = biquad_block(bq_state, y, frames, sos)
        return (ols_state, bq_state), y

    state = (ols_init_state(C, block, spec.shape[1]), biquad_init_state(C, 1))
    x = jnp.asarray(rng.standard_normal((C, block)), jnp.float32)
    return [_chunk_bench(
        "4_ols64k_eq_16ch", fn, state, x, C * block, note="8192-frame blocks"
    )]


def config5():
    """The flagship 64-ch chain on a mesh over all visible devices."""
    from pipe_tpu import ops, parallel

    n = len(jax.devices())
    ch = 2 if n % 2 == 0 and n >= 2 else 1
    t = n // ch
    mesh = parallel.make_mesh(ch, t)
    C, chunk = 64, 147 * 2048 * t
    h = ops.design_lowpass(255, 4000, 44100)
    mixm = np.ones((2, C), np.float32) / C
    chain = parallel.ShardedChain(
        mesh,
        [
            parallel.FIRStage(h),
            parallel.ResampleStage(48000, 44100, taps_per_phase=32),
            parallel.MixStage(mixm),
        ],
        channels=C,
        chunk_frames=chunk,
    )
    x = jnp.asarray(
        np.random.default_rng(2).standard_normal((C, chunk)), jnp.float32
    )
    for _ in range(3):
        y = chain.step(x)
    jax.block_until_ready(y)
    steps = 64
    t0 = time.perf_counter()
    for _ in range(steps):
        y = chain.step(x)
    jax.block_until_ready(y)
    dt = (time.perf_counter() - t0) / steps
    return [_emit(
        "5_sharded_64ch_mix",
        C * chunk,
        dt,
        f"mesh {ch}x{t} over {n} device(s)",
    )]


ALL = {f.__name__[-1]: f for f in (config1, config2, config3, config4, config5)}

if __name__ == "__main__":
    from benchmarks import device

    _devices = device.require_gpu()
    device.enable_compile_cache()
    device.print_header(_devices)
    which = sys.argv[1:] or sorted(ALL)
    for k in which:
        ALL[k]()
