"""The flagship 64-channel chain on a device mesh — the scaling story in
~40 lines. Works anywhere: on a host with several GPUs it shards over the
cards; on a laptop run with

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_flagship.py --cpu

to see the identical program execute over 8 virtual devices (channels x
time sharding, ppermute halo exchange, psum mixer).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import time

import jax
import numpy as np

from pipe_tpu import ops, parallel


def main():
    n = len(jax.devices())
    ch = 2 if n % 2 == 0 and n >= 2 else 1
    t = n // ch
    mesh = parallel.make_mesh(ch, t)
    print(f"devices: {n}  mesh: {ch} channel-shards x {t} time-shards")

    C = 64
    chunk = 147 * 32 * t  # divisible by the time axis and the rate ratio
    h = ops.design_lowpass(255, 4000, 44100)
    chain = parallel.ShardedChain(
        mesh,
        [
            parallel.FIRResampleStage(h, 48000, 44100),  # fused bank
            # the compressor sits AFTER the resampler: envelope time
            # constants must use the post-resample rate
            parallel.CompressorStage(threshold_db=-18.0, ratio=4.0,
                                     sample_rate=48000.0),
            parallel.MixStage(np.ones((2, C), np.float32) / C),
        ],
        channels=C,
        chunk_frames=chunk,
    )

    rng = np.random.default_rng(0)
    x = rng.standard_normal((C, chunk)).astype(np.float32)
    y = chain.step(x)  # compile
    t0 = time.perf_counter()
    steps = 20
    for _ in range(steps):
        y = chain.step(x)
    jax.block_until_ready(y)
    dt = (time.perf_counter() - t0) / steps
    print(f"out shape {tuple(y.shape)}  ~{C * chunk / dt / 1e6:.0f} Msamples/s")

    # live retune between chunks: traced params, no recompile
    chain.stages[1].params["threshold_db"] = np.float32(-30.0)
    y2 = chain.step(x)
    print("retuned threshold mid-stream; output delta:",
          float(np.abs(np.asarray(y2) - np.asarray(y)).max()) > 0)


if __name__ == "__main__":
    main()
