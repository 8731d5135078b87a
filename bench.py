"""Benchmark: samples/s on one GPU for the 64-channel FIR(255) + 44.1k->48k
polyphase resample + merged mix chain (BASELINE.md headline config).

Prints the device lines (platform, device kind and count, the card's
nvidia-smi name and power limit), then ONE JSON line:
  {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N,
   "device": {...}, "configs": {...}}

``value`` is input samples (frames x channels) processed per wall second in
steady state on one card. The reference publishes no performance numbers
(BASELINE.md: 'The reference publishes none'), so ``vs_baseline`` reports
the multiple of REAL-TIME for this chain (64 ch x 44100 Hz = 2.8224
Msamples/s): how many live 64-channel pipelines one card sustains.

Methodology: steps chain through carried state (donated), so they serialize
on the device without host syncs; a timed run of ``BENCH_STEPS`` steps ends
in ``jax.block_until_ready`` on the last output and state. It needs a GPU
and exits non-zero without one; a config that fails fails the run.
"""

from __future__ import annotations

import json
import os
import time


def main():
    from benchmarks import device

    devices = device.require_gpu()
    device.enable_compile_cache()
    device.print_header(devices)

    import jax

    from pipe_tpu.flagship import make_flagship, SAMPLE_RATE

    channels = int(os.environ.get("BENCH_CHANNELS", "64"))
    chunk = 147 * int(os.environ.get("BENCH_CHUNK_BLOCKS", "2048"))
    steps = int(os.environ.get("BENCH_STEPS", "64"))

    fn, state, x = make_flagship(channels=channels, chunk=chunk)
    step = jax.jit(fn, donate_argnums=(0,))
    x = jax.device_put(x)
    state = jax.device_put(state)
    for _ in range(3):  # compile + warm
        state, y = step(state, x)
    jax.block_until_ready((state, y))

    t0 = time.perf_counter()
    for _ in range(steps):
        state, y = step(state, x)
    jax.block_until_ready((state, y))
    dt = (time.perf_counter() - t0) / steps

    sps = chunk * channels / dt
    realtime = channels * SAMPLE_RATE

    # every BASELINE.md config, measured on the same card in the same run
    configs = {}
    if os.environ.get("BENCH_CONFIGS", "1") != "0":
        from benchmarks import configs as cfg

        cfg.QUIET = True
        for key in sorted(cfg.ALL):
            for rec in cfg.ALL[key]():
                configs[rec.pop("config")] = rec

    print(
        json.dumps(
            {
                "metric": "samples_per_s_64ch_fir255_resample_mix",
                "value": sps,
                "unit": "samples/s",
                "vs_baseline": sps / realtime,
                "device": device.device_record(devices),
                "configs": configs,
            }
        )
    )


if __name__ == "__main__":
    main()
