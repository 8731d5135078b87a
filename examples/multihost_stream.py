"""Multi-host streaming — the full Pipe runtime across a process group.

Run with no arguments and the script launches itself twice (two "hosts" on
this machine, CPU backend, 2 virtual devices each — the same code runs
unchanged across real hosts; drop the CPU forcing and pass each host its
real process_id/coordinator. On one host with several GPUs, one process
drives them all instead):

    python examples/multihost_stream.py

Every host runs the IDENTICAL program: a global (1 x 4) mesh whose time
axis spans both processes, so the FIR filter tail crosses the process edge as
a `ppermute` halo on every chunk. The stream carries state chunk-to-chunk,
a `set_taps` mutation is pushed with `at_block=` so it lands on the same
sample everywhere, and each host's sink receives the WHOLE stream (outputs
are gathered across processes). First-error-wins crosses the group via the
aligned health rounds in `pipe_tpu.parallel.hostsync`.
"""

import os
import subprocess
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PROC = 2


def launch():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), coord],
            env=env,
        )
        for pid in range(N_PROC)
    ]
    raise SystemExit(max(p.wait() for p in procs))


def worker(pid: int, coord: str):
    # local demo: CPU backend, 2 virtual devices per "host"
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import scipy.signal

    import pipe_tpu
    from pipe_tpu import mock, ops, parallel
    from pipe_tpu.components import Source
    from pipe_tpu.signal import SignalProperties, snr_db

    parallel.initialize(
        coordinator_address=coord, num_processes=N_PROC, process_id=pid
    )
    mesh = parallel.make_global_mesh(channel_shards=1, time_shards=4)

    C, CHUNK, N_CHUNKS, SWITCH = 2, 512, 200, 100
    h1 = np.asarray(ops.design_lowpass(63, 4000, 44100))
    h2 = h1 * 0.25

    # identical stream on every host (same seed) — the multi-host contract
    rng = np.random.default_rng(42)
    data = rng.standard_normal((C, CHUNK * N_CHUNKS)).astype(np.float32)
    pos = [0]

    def feed(n):
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0] : pos[0] + n]
        pos[0] += n
        return c

    fir = parallel.sharded.FIR(h1)
    sink = mock.Sink()
    p = pipe_tpu.Pipe(
        CHUNK,
        pipe_tpu.Line(
            source=lambda ctx, b: Source(
                output=SignalProperties(44100.0, C), feed=feed
            ),
            processors=[fir.processor()],
            sink=sink.sink(),
        ),
        mesh=mesh,
    )
    p.start()
    p.push(fir.set_taps(h2), at_block=SWITCH)  # same sample on every host
    p.wait(300.0)

    x64 = data.astype(np.float64)
    y1 = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
    y2 = scipy.signal.lfilter(h2, [1.0], x64, axis=1)
    s = SWITCH * CHUNK
    oracle = np.concatenate([y1[:, :s], y2[:, s:]], axis=1)
    snr = snr_db(oracle, sink.values)
    print(f"host {pid}: {N_CHUNKS} chunks streamed, SNR {snr:.1f} dB")
    assert snr > 100


if __name__ == "__main__":
    if len(sys.argv) == 1:
        launch()
    worker(int(sys.argv[1]), sys.argv[2])
