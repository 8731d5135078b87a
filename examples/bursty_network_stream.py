"""Bursty network-style source + live sample-rate conversion (r5 surfaces).

A "network receiver" source hands the pipe packets of random size (1..400
frames) — the reference's accept-any-length SourceFunc contract
(``pipe.go:404-406``). On a (1 x 4) mesh the executor re-chunks the
packets host-side into full dispatch chunks (exact: repacking changes no
sample values). Mid-stream, a 44.1k->48k resampler is LIVE-INSERTED at an
exact chunk boundary; the downstream FIR is re-allocated at the new block
width with its filter tail carried, so the stream never glitches.

Run on GPUs directly, or on a laptop:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/bursty_network_stream.py --cpu
"""

import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import scipy.signal

import pipe_tpu
from pipe_tpu import mock, ops, parallel
from pipe_tpu.components import Source
from pipe_tpu.signal import SignalProperties, snr_db


def main():
    C, CHUNK, N_CHUNKS = 2, 588, 12  # 588: n_local=147 fits 160/147
    N = CHUNK * N_CHUNKS
    rng = np.random.default_rng(5)
    data = rng.standard_normal((C, N)).astype(np.float32)

    # the "network": packets of 1..400 frames, whenever they arrive
    pos = [0]
    packets = [0]
    gate = threading.Event()

    def recv_packet(n):
        if pos[0] >= 2 * CHUNK:
            gate.wait(60)  # simulated stall while we retune the graph
        if pos[0] >= N:
            return None
        take = min(int(rng.integers(1, 401)), n, N - pos[0])
        pkt = data[:, pos[0] : pos[0] + take]
        pos[0] += take
        packets[0] += 1
        return pkt

    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    fir = parallel.sharded.FIR(h)
    sink = mock.Sink()
    p = pipe_tpu.Pipe(
        CHUNK,
        pipe_tpu.Line(
            source=lambda ctx, b: Source(
                output=SignalProperties(44100.0, C), feed=recv_packet
            ),
            processors=[fir.processor()],
            sink=sink.sink(),
        ),
        mesh=parallel.make_mesh(1, 4),
    )
    p.start()

    # live surgery: convert the stream to 48 kHz from chunk 4 onward
    AT = 4
    handle = p.insert_processor(
        0, 0, parallel.sharded.Resample(48000, 44100).processor(), at_block=AT
    )
    le = p._exec_of_route[0]
    deadline = time.time() + 60
    while le._next_target(0) != AT and time.time() < deadline:
        time.sleep(0.002)
    gate.set()
    assert handle.wait(60) and handle.error is None, handle.error
    p.wait(120)

    # oracle: raw to the cut, polyphase-resampled after, one continuous FIR
    from pipe_tpu.ops.resample import polyphase_design

    cut = AT * CHUNK
    L, M = 160, 147
    hp64 = polyphase_design(L, M, 32)
    K = hp64.shape[1]
    tail = data.astype(np.float64)[:, cut:]
    n_out = -(-tail.shape[1] * L // M)
    j = np.arange(n_out)
    ph, n0 = (j * M) % L, (j * M) // L
    nidx = n0[:, None] - np.arange(K)[None, :]
    valid = (nidx >= 0) & (nidx < tail.shape[1])
    xg = np.where(
        valid[None], tail[:, np.clip(nidx, 0, tail.shape[1] - 1)], 0.0
    )
    res = np.einsum("cok,ok->co", xg, hp64[ph])
    stream = np.concatenate([data.astype(np.float64)[:, :cut], res], axis=1)
    oracle = scipy.signal.lfilter(h, [1.0], stream, axis=1)

    print(
        f"{packets[0]} packets re-chunked into {N // CHUNK} dispatch "
        f"chunks; 48k conversion landed at chunk {AT}"
    )
    print(
        f"out {sink.values.shape}, SNR vs float64 oracle: "
        f"{snr_db(oracle, sink.values):.1f} dB"
    )


if __name__ == "__main__":
    main()
