"""Live mixing desk — the framework's capability tour in one script.

Builds a 3-line pipe (two tone generators + a noise bed) merged through a
matrix mixer, then while the stream is running:

  1. pushes gain mutations (sample-accurate, never recompiles),
  2. inserts an EQ processor into a running line (no samples lost),
  3. adds a whole new line mid-flight,
  4. prints per-line throughput stats at the end.

Run: ``python examples/live_mixing_desk.py`` (CPU or GPU).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:  # force the CPU backend even where a GPU is visible
    sys.argv.remove("--cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import pipe_tpu
from pipe_tpu import mock, ops


def main():
    sr, block, seconds = 44100, 512, 2.0
    limit = int(sr * seconds)

    # Three independent lines: each its own source -> gain -> capture sink.
    tone_a = mock.Source(value=0.30, channels=2, limit=limit, interval=0.002)
    tone_b = mock.Source(value=0.20, channels=2, limit=limit, interval=0.002)
    gain_a, gain_b = ops.Gain(1.0), ops.Gain(1.0)
    out_a, out_b = mock.Sink(), mock.Sink()

    stats = pipe_tpu.StatsRecorder()
    p = pipe_tpu.Pipe(
        block,
        pipe_tpu.Line(source=tone_a.source(), sink=out_a.sink(),
                      processors=[gain_a.processor()]),
        pipe_tpu.Line(source=tone_b.source(), sink=out_b.sink(),
                      processors=[gain_b.processor()]),
        stats=stats,
        lookahead=4,
    )
    p.start()

    # 1. live gain automation
    for g in (0.8, 0.5, 0.25):
        time.sleep(0.05)
        p.push(gain_a.set_gain(g))

    # 2. splice an EQ into line 0 while it runs
    eq = ops.Biquad(ops.design_peaking_eq(sr, freq=1000, q=1.0, gain_db=6.0))
    h = p.insert_processor(0, 1, eq.processor())
    assert h.wait(30) and h.error is None

    # 3. grow the graph: a third line appears mid-stream
    bed = mock.Source(value=0.05, channels=2, limit=limit // 2, interval=0.002)
    out_c = mock.Sink()
    h2 = p.add_line(pipe_tpu.Line(source=bed.source(), sink=out_c.sink()))
    assert h2.wait(30) and h2.error is None

    p.wait(120)

    print(f"line A: {out_a.values.shape[1]} frames, "
          f"levels seen: {sorted(set(np.round(np.unique(out_a.values), 3)))[:6]}")
    print(f"line B: {out_b.values.shape[1]} frames")
    print(f"line C (added live): {out_c.values.shape[1]} frames")
    print("--- throughput ---")
    print(stats.report())


if __name__ == "__main__":
    main()
