"""Weak-scaling harness for the sharded flagship chain.

Measures samples/s at increasing mesh sizes with PER-DEVICE work held
constant, and reports efficiency vs the single-device rate — the
BASELINE.md "≥80% scaling" metric. On the four GPUs of one host (all to
all over NVLink) this measures the halo + psum overhead of the sharded
chain: ``python benchmarks/scaling.py``. It refuses to time anything but
GPUs and prints the device lines first.

One JSON line per mesh size:
  {"devices": N, "mesh": "CxT", "samples_per_s": ..., "efficiency": ...}

``--collectives`` instead performs STATIC collective-traffic accounting:
it compiles each stage's sharded chunk step on the virtual mesh, walks the
optimized HLO, and sums the bytes moved by every collective op per step —
arithmetic backing for the ≥80% scaling claim (collective bytes per chunk
must stay small against the per-device chunk payload; see
docs/PERF_NOTES.md). Shapes in SPMD HLO are per-device, so the numbers are
per-device per-chunk. This mode counts bytes, not time, so it runs on
virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python benchmarks/scaling.py --collectives
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# a virtual-device request means the CPU backend (the --collectives mode)
if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from pipe_tpu import ops, parallel

CH_PER_DEVICE = 16
BLOCKS_PER_DEVICE = 256  # x147 frames


def mesh_shapes(n: int):
    """(ch, time) factorizations to test at n devices, channel-major."""
    out = []
    for ch in (1, 2, 4, 8):
        if ch <= n and n % ch == 0:
            out.append((ch, n // ch))
    return out


def measure(ch: int, t: int) -> float:
    n = ch * t
    mesh = parallel.make_mesh(ch, t)
    C = CH_PER_DEVICE * ch
    chunk = 147 * BLOCKS_PER_DEVICE * t
    h = ops.design_lowpass(255, 4000, 44100)
    chain = parallel.ShardedChain(
        mesh,
        [
            parallel.FIRResampleStage(h, 48000, 44100),
            parallel.MixStage(np.ones((2, C), np.float32) / C),
        ],
        channels=C,
        chunk_frames=chunk,
    )
    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal((C, chunk)).astype(np.float32))
    jax.block_until_ready(chain.step(x))  # compile + settle
    steps = 20
    t0 = time.perf_counter()
    for _ in range(steps):
        y = chain.step(x)
    jax.block_until_ready(y)
    return C * chunk * steps / (time.perf_counter() - t0)


# -- static collective-traffic accounting (--collectives) -------------------

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
    "pred": 1, "c64": 8, "c128": 16,
}
_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_KIND_RE = re.compile(
    r"[\s=](collective-permute|all-gather|all-reduce|reduce-scatter|"
    r"all-to-all)\("
)


def collective_bytes(hlo_text: str) -> dict:
    """Sum output-shape bytes of every collective op in optimized HLO.
    Convention: per-device per-step OUTPUT bytes (for all-gather that is
    the full gathered buffer; a device's received traffic is (g-1)/g of
    it, and a ring all-reduce moves ~2x — the table stays in raw output
    bytes and notes the convention). Output may be a TUPLE (all-to-all
    emits one element per participant); every shape on the op's left-hand
    side is summed."""
    out: dict = {}
    for line in hlo_text.splitlines():
        m = _KIND_RE.search(line)
        if m is None:
            continue
        lhs = line[: m.start()]
        if "=" not in lhs:
            continue  # an operand reference, not an op definition
        total = 0
        for dtype, dims in _SHAPE_RE.findall(lhs):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * _DTYPE_BYTES.get(dtype, 4)
        kind = m.group(1)
        out[kind] = out.get(kind, 0) + total
    return out


def collective_ops(hlo_text: str) -> int:
    """Count collective OP DEFINITIONS in optimized HLO — the dependency-
    structure twin of :func:`collective_bytes`: a log-ladder prefix emits
    O(log T) collectives, a serialized (unrolled) cross-device scan O(T).
    CI asserts sublinear growth (tests/test_scaling_smoke.py)."""
    n = 0
    for line in hlo_text.splitlines():
        m = _KIND_RE.search(line)
        if m is not None and "=" in line[: m.start()]:
            n += 1
    return n


def account_collectives():
    from pipe_tpu import parallel as par

    mesh = par.make_mesh(2, 4)
    C = 16
    rng = np.random.default_rng(0)
    sos = ops.design_peaking_eq(44100, freq=1000, q=10.0, gain_db=6.0)
    h255 = ops.design_lowpass(255, 4000, 44100)
    ir64k = (
        rng.standard_normal(65536) * np.exp(-np.arange(65536) / 8000.0)
    ).astype(np.float32)

    cases = [
        ("gain", [par.GainStage(0.5)], 32768),
        ("fir255", [par.FIRStage(h255)], 32768),
        ("fir_resample_160_147", [par.FIRResampleStage(h255, 48000, 44100)], 147 * 256 * 4),
        ("ols_64k_reverb", [par.OLSStage(ir64k)], 32768),
        ("biquad_refined", [par.BiquadStage(sos)], 32768),
        ("biquad_norefine", [par.BiquadStage(sos, refine=False)], 32768),
        ("compressor", [par.CompressorStage()], 32768),
        ("delay_pure_300", [par.DelayStage(300, wet=1.0)], 32768),
        ("delay_pure_5000", [par.DelayStage(5000, wet=1.0)], 32768),
        ("delay_feedback_300", [par.DelayStage(300, feedback=0.5)], 32768),
        ("spectral_gain_1024", [par.SpectralGainStage(1024, 256)], 32768),
        ("mix_psum", [par.MixStage(np.ones((2, C), np.float32) / C)], 32768),
    ]
    for name, stages, chunk in cases:
        chain = par.ShardedChain(mesh, stages, channels=C, chunk_frames=chunk)
        x = np.zeros((C, chunk), np.float32)
        txt = (
            chain._step.lower(chain.carries, chain.params(), x)
            .compile()
            .as_text()
        )
        coll = collective_bytes(txt)
        n_local = chunk // mesh.shape["time"]
        c_local = C // mesh.shape["ch"]
        payload = c_local * n_local * 4
        total_coll = sum(coll.values())
        print(
            json.dumps(
                {
                    "stage": name,
                    "chunk_frames": chunk,
                    "payload_bytes_per_device": payload,
                    "collective_bytes_per_device": total_coll,
                    "ratio": round(total_coll / payload, 4),
                    "by_kind": coll,
                }
            ),
            flush=True,
        )


def main():
    if "--collectives" in sys.argv:
        account_collectives()
        return
    from benchmarks import device

    devices = device.require_gpu()
    device.enable_compile_cache()
    device.print_header(devices)
    total = len(devices)
    sizes = sorted({1, 2, total // 2 if total >= 4 else total, total})
    base = None
    for n in sizes:
        if n < 1 or total % n:
            continue
        ch, t = mesh_shapes(n)[-1] if n > 1 else (1, 1)
        sps = measure(ch, t)
        per_dev = sps / n
        if base is None:
            base = per_dev
        print(
            json.dumps(
                {
                    "devices": n,
                    "mesh": f"{ch}x{t}",
                    "samples_per_s": sps,
                    "per_device": per_dev,
                    "efficiency": per_dev / base,
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
