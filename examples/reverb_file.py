"""Convolution reverb over a WAV file — the file-to-file production path.

Synthesizes a test WAV, then streams it through a 64k-tap convolution
reverb (partitioned overlap-save FFT) + peaking EQ into an output WAV via
the native C++ reader/writer with prefetch.

Run: ``python examples/reverb_file.py [in.wav] [out.wav]``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:  # force the CPU backend even where a GPU is visible
    sys.argv.remove("--cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import pipe_tpu
from pipe_tpu import native, ops
from pipe_tpu.io import WavSink, WavSource


def synth_input(path, sr=44100, seconds=2.0):
    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.exp(-t * 2.0)
    stereo = np.stack([x, x * 0.8]).astype(np.float32)
    w = native.WavWriter(path, 2, sr, 32)
    w.write(np.ascontiguousarray(stereo.T))
    w.close()


def main():
    in_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/reverb_in.wav"
    out_path = sys.argv[2] if len(sys.argv) > 2 else "/tmp/reverb_out.wav"
    if not os.path.exists(in_path):
        synth_input(in_path)

    # Exponentially-decaying noise IR ~1.5 s at 44.1k (65536 taps).
    rng = np.random.default_rng(7)
    n = 65536
    ir = rng.standard_normal(n) * np.exp(-np.arange(n) / 12000.0) * 0.05

    src = WavSource(in_path)
    dst = WavSink(out_path, bits=32)
    reverb = ops.OLSConvolve(ir)
    eq = ops.Biquad(ops.design_peaking_eq(src.sample_rate, 2500, 0.9, -3.0))

    stats = pipe_tpu.StatsRecorder()
    pipe_tpu.run(
        4096,
        pipe_tpu.Line(
            source=src.source(),
            processors=[reverb.processor(), eq.processor()],
            sink=dst.sink(),
        ),
        stats=stats,
        lookahead=8,
    )
    print(f"wrote {dst.frames_written} frames to {out_path}")
    print(stats.report())


if __name__ == "__main__":
    main()
