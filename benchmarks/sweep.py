"""Tuning sweep on the GPU: the FIR frame size S and the resampler
supercycle group G at the flagship width (64 channels x 301,056 frames),
and the biquad recurrence engines (associative scan vs tiled Toeplitz
scan) alone and inside benchmark config 4's step (OLS 64k + EQ, 16 and 64
channels, 8,192-frame blocks).

Run: ``python benchmarks/sweep.py``. Prints the device lines, one line per
timing, and writes every timing to ``chiprun_out/sweep.json`` (rewritten after each section). Times are
medians of several rounds of ``steps`` calls each, ended by
``jax.block_until_ready``; the rounds of competing variants alternate so a
clock drift hits all of them alike. It needs a GPU and refuses the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import device  # noqa: E402

C = 64
B = 147 * 2048  # flagship chunk: 301,056 frames
ROUNDS = 5


def _timer(fn, args, steps):
    import jax

    f = jax.jit(fn)
    jax.block_until_ready(f(*args))  # compile + warm

    def run():
        t0 = time.perf_counter()
        for _ in range(steps):
            out = f(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / steps

    return run


def race(variants, args, steps=10):
    """variants: {name: fn}. Median seconds per call of each, rounds
    alternating in rotated order."""
    runs = {k: _timer(fn, args, steps) for k, fn in variants.items()}
    times = {k: [] for k in runs}
    names = list(runs)
    for r in range(ROUNDS):
        for k in names[r % len(names):] + names[: r % len(names)]:
            times[k].append(runs[k]())
    return {k: statistics.median(v) for k, v in times.items()}


def main():
    devices = device.require_gpu()
    device.enable_compile_cache()
    device.print_header(devices)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pipe_tpu import ops
    from pipe_tpu.ops import biquad as bq
    from pipe_tpu.ops import fir as fir_m
    from pipe_tpu.ops.ols import ols_block, ols_init_state, partition_ir
    from pipe_tpu.ops.resample import polyphase_design, resample_apply

    out = {"device": device.device_record(devices),
           "card": device.card_name_and_power()}

    path = os.path.join(device.REPO, "chiprun_out", "sweep.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def report(section, res, samples):
        out[section] = {k: v * 1e6 for k, v in res.items()}
        for k, v in res.items():
            print(f"{section} {k}: {v * 1e6:.1f} us/call "
                  f"{samples / v / 1e9:.3f} Gsamples/s", flush=True)
        with open(path, "w") as f:  # rewritten after every section
            json.dump(out, f, indent=1)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((C, B)), jnp.float32)
    h = jnp.asarray(ops.design_lowpass(255, 4000.0, 44100.0), jnp.float32)
    tail = fir_m.fir_init_tail(C, 255)
    report("fir255_64ch S", race(
        {f"S={S}": (lambda x, S=S: fir_m._fir_frames(tail, x, h, S))
         for S in (32, 64, 128, 256)}, (x,)), C * B)

    hp = jnp.asarray(polyphase_design(160, 147, 32), jnp.float32)
    hist = jnp.zeros((C, 31), jnp.float32)
    report("resample_64ch G", race(
        {f"G={G}": (lambda x, G=G: resample_apply(hist, x, hp, 160, 147, G))
         for G in (1, 2, 4, 8)}, (x,)), C * B)

    # -- biquad recurrence engines ------------------------------------------
    sos = ops.design_peaking_eq(44100, freq=1000, q=1.0, gain_db=3.0)
    a1, a2 = jnp.float32(sos[4]), jnp.float32(sos[5])

    def engines(Cb, Bb):
        v = jnp.asarray(rng.standard_normal((Cb, Bb)), jnp.float32)
        s = jnp.zeros((Cb, 2), jnp.float32)
        paths = ["assoc"] + (["tiles"] if Bb % bq._TILE_Q == 0 else [])
        res = race({p: (lambda v, p=p: bq._iir_apply(v, s, a1, a2, p))
                    for p in paths}, (v,), steps=20)
        report(f"iir C={Cb} B={Bb}", res, Cb * Bb)

    for Cb in (2, 16, 64):
        for Bb in (512, 2048, 8192):
            engines(Cb, Bb)

    # -- config 4 step (OLS 64k-tap reverb + peaking EQ), end to end ---------
    block = 8192
    ir = rng.standard_normal(65536) * np.exp(-np.arange(65536) / 8000)
    spec = jnp.asarray(partition_ir(ir, block))
    sos_j = jnp.asarray(np.asarray(sos[None, :], np.float32))
    frames = jnp.asarray(block, jnp.int32)

    for Cb in (16, 64):
        xb = jnp.asarray(rng.standard_normal((Cb, block)), jnp.float32)
        ols0 = ols_init_state(Cb, block, spec.shape[1])
        bq0 = bq.biquad_init_state(Cb, 1)

        def step(x, path):
            old = bq._iir_path
            bq._iir_path = lambda b, backend=None: path
            try:
                o, y = ols_block(ols0, x, frames, spec)
                return bq.biquad_block(bq0, y, frames, sos_j)[1]
            finally:
                bq._iir_path = old

        variants = {p: (lambda x, p=p: step(x, p)) for p in ("assoc", "tiles")}
        variants["ols only"] = lambda x: ols_block(ols0, x, frames, spec)[1]
        report(f"config4 step C={Cb}", race(variants, (xb,), steps=20),
               Cb * block)


if __name__ == "__main__":
    main()
