"""Scaling layer — meshes, halo exchange, and the sharded chunk runner.

This replaces the reference's entire concurrency apparatus (goroutines +
cap-1 channels, ``fitting.go:81-104``; SURVEY.md §2 parallelism table) with
device-level constructs:

- **channel axis** = data parallelism: lines/channels sharded over devices;
  per-channel ops need no communication; the merged mixer sink reduces with
  ``psum`` across devices.
- **time axis** = sequence parallelism: a long chunk is split into
  contiguous time-blocks, one per device; stateful ops receive their left
  neighbor's trailing samples (filter tails, OLS history) as a *halo* via
  ``ppermute`` — the overlap-save boundary exchange of BASELINE.json's
  north star.
- IIR recurrences cross device boundaries through an associative scan over
  the mesh: per-device scan products are all-gathered (tiny 2x2 matrices)
  and prefix-combined, so even feedback filters shard over time.
"""

from pipe_tpu.parallel.mesh import make_mesh, CH_AXIS, TIME_AXIS
from pipe_tpu.parallel.halo import halo_from_left, last_shard
from pipe_tpu.parallel.distributed import (
    initialize,
    make_global_mesh,
    shard_host_chunk,
)
from pipe_tpu.parallel.meshctx import mesh_scope, current_mesh
from pipe_tpu.parallel import components as sharded
from pipe_tpu.parallel.chain import (
    ShardedChain,
    GainStage,
    FIRStage,
    FIRResampleStage,
    OLSStage,
    ResampleStage,
    BiquadStage,
    CompressorStage,
    SpectralGainStage,
    SpectralGateStage,
    MixStage,
    DelayStage,
    GateStage,
    LimiterStage,
    ChannelizerStage,
    IQMixStage,
    EnvelopeDetectorStage,
    FMDiscriminatorStage,
    FIRGainStage,
    MixGainStage,
    BiquadCascadeStage,
)

__all__ = [
    "make_mesh",
    "initialize",
    "make_global_mesh",
    "shard_host_chunk",
    "CH_AXIS",
    "TIME_AXIS",
    "halo_from_left",
    "last_shard",
    "mesh_scope",
    "current_mesh",
    "sharded",
    "ShardedChain",
    "GainStage",
    "FIRStage",
    "FIRResampleStage",
    "OLSStage",
    "ResampleStage",
    "BiquadStage",
    "CompressorStage",
    "SpectralGainStage",
    "SpectralGateStage",
    "MixStage",
    "DelayStage",
    "GateStage",
    "LimiterStage",
    "ChannelizerStage",
    "IQMixStage",
    "EnvelopeDetectorStage",
    "FMDiscriminatorStage",
    "FIRGainStage",
    "MixGainStage",
    "BiquadCascadeStage",
]
