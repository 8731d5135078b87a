"""Worker program for the multi-process test (one of N identical
processes; see test_distributed.py). Exercises the real
``jax.distributed.initialize`` path, a global mesh spanning both
processes, per-host chunk sharding, cross-process halo exchange, and the
psum mixer reduction — the full multi-host recipe from
``pipe_tpu.parallel.distributed`` on CPU devices.

Usage: python dcn_worker.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from pipe_tpu import parallel

    parallel.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc
    assert jax.device_count() == 2 * nproc

    import numpy as np
    import scipy.signal

    from pipe_tpu import ops
    from pipe_tpu.signal import snr_db

    # channel axis spans processes, time axis local
    mesh = parallel.make_global_mesh(channel_shards=nproc, time_shards=2)
    C, chunk = 2 * nproc, 2352
    h = ops.design_lowpass(101, 4000, 44100)
    chain = parallel.ShardedChain(
        mesh,
        [parallel.FIRStage(h), parallel.MixStage(np.ones((1, C), np.float32))],
        channels=C,
        chunk_frames=chunk,
    )
    rng = np.random.default_rng(0)  # same stream on every host
    xg = rng.standard_normal((C, chunk)).astype(np.float32)
    per = C // nproc
    x = parallel.shard_host_chunk(mesh, xg[pid * per : (pid + 1) * per, :])
    y = chain.step(x)
    out = np.asarray(jax.device_get(y))

    oracle = scipy.signal.lfilter(h, [1.0], xg.astype(np.float64), axis=1).sum(
        0, keepdims=True
    )
    s = snr_db(oracle, out)
    assert s > 100, f"proc {pid}: SNR {s:.1f} dB"
    print(f"proc {pid} OK {s:.1f} dB", flush=True)


if __name__ == "__main__":
    main()
