"""Any-shape mesh placement + whole-line fusion (r4 surfaces) in ~60 lines.

A 7-channel pipeline at block 501 on a (2 x 4) mesh: neither the channel
count nor the block size fits the mesh, and the pipe handles both —
channels ride zero pad rows (sliced off at the sink), and the block
aggregates to the smallest multiple every stage accepts. optimize=True
collapses the two FIRs into one cascaded conv (the gain stays a cheap
standalone stage); the retune through the ORIGINAL object still lands,
recompile-free.

Run on GPUs directly, or on a laptop:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/odd_shapes_and_fusion.py --cpu
"""

import os
import sys

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
    mesh = parallel.make_mesh(2, 4)
    C, BLOCK = 7, 501  # 7 channels on 2 shards, block 501 on 4 shards
    rng = np.random.default_rng(0)
    data = rng.standard_normal((C, BLOCK * 64)).astype(np.float32)
    pos = [0]

    def feed(n):
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0] : pos[0] + n]
        pos[0] += n
        return c

    def src(ctx, block):
        return Source(output=SignalProperties(44100.0, C), feed=feed)

    h1 = ops.design_lowpass(63, 8000.0, 44100.0)
    h2 = ops.design_lowpass(31, 4000.0, 44100.0)
    f1 = parallel.sharded.FIR(h1)
    f2 = parallel.sharded.FIR(h2)
    g = parallel.sharded.Gain(0.5)
    sink = mock.Sink()

    p = pipe_tpu.Pipe(
        BLOCK,
        pipe_tpu.Line(
            source=src,
            processors=[f1.processor(), f2.processor(), g.processor()],
            sink=sink.sink(),
        ),
        mesh=mesh,
        optimize=True,  # FIR+FIR -> one cascade at build
    )
    print(f"block aggregation: {p._agg} user blocks per dispatch")
    print(f"stages after fusion: {len(p.routes[0].processors)}")
    p.start()
    # retune the SECOND FIR through its original handle: routes to its
    # slot of the fused cascade, lands at a dispatch boundary
    p.push(f2.set_taps(ops.design_lowpass(31, 2000.0, 44100.0)),
           at_block=8 * p._agg)
    p.wait(300)

    out = sink.values
    o = data.astype(np.float64)
    o = scipy.signal.lfilter(np.asarray(h1), [1.0], o, axis=1)
    a = scipy.signal.lfilter(np.asarray(h2), [1.0], o, axis=1)
    b = scipy.signal.lfilter(
        np.asarray(ops.design_lowpass(31, 2000.0, 44100.0)), [1.0], o, axis=1
    )
    s = 8 * p._agg * BLOCK
    oracle = 0.5 * np.concatenate([a[:, :s], b[:, s:]], axis=1)
    print(f"out {out.shape}, SNR vs oracle: {snr_db(oracle, out):.1f} dB")


if __name__ == "__main__":
    main()
