"""pipe_tpu — a streaming DSP pipeline framework on JAX/XLA.

A pipeline is a graph of *lines*; each line is ``Source -> [0..n Processors]
-> Sink`` operating on fixed-size float time-blocks. This mirrors the
capability surface of the Go reference (``pipelined.dev/pipe``, see its
``doc.go:1-79``) but the design is accelerator-first:

- The per-buffer hot loop (reference ``run.go:215-217`` + ``pipe.go:381-471``)
  becomes a SINGLE fused, jitted XLA computation per time-block per line.
  There is no goroutine-per-stage and no channel transport on the hot path —
  XLA fuses the stage chain into one kernel schedule in device memory.
- Components are pure functions over pytrees:
  ``(state, params, signal) -> (state, signal)``. Mutable parameters are
  *traced inputs*, so a pushed mutation is just a new leaf value — it never
  retraces or recompiles.
- The mutability system (reference ``mutable/mutable.go``) survives as a
  host-side control plane with the same ordering guarantee: a mutation pushed
  while the stream runs is applied at a deterministic block boundary, in push
  order, race-free (the reference applies per-buffer; blocks are our buffers).
- Scaling is done with ``jax.sharding`` meshes: channels are sharded as the
  data-parallel axis, time-blocks as the sequence axis with overlap-save halo
  exchange of filter tails via ``ppermute`` between devices (see
  ``pipe_tpu.parallel``).
"""

from pipe_tpu.signal import (
    Signal,
    SignalProperties,
    silence,
    from_array,
)
from pipe_tpu import mutable
from pipe_tpu.errors import (
    PipeError,
    AllocationError,
    StartError,
    FlushError,
    RunError,
    ErrorRun,
)
from pipe_tpu.components import (
    Source,
    Processor,
    Sink,
    SourceAllocatorFunc,
    ProcessorAllocatorFunc,
    SinkAllocatorFunc,
)
from pipe_tpu.graph import Line, Processors
from pipe_tpu.runtime import Pipe, run, wait
from pipe_tpu.profiling import StatsRecorder, trace
from pipe_tpu.offline import process
from pipe_tpu import checkpoint
from pipe_tpu import config
from pipe_tpu import optimize

__version__ = "0.1.0"

__all__ = [
    "config",
    "Signal",
    "SignalProperties",
    "silence",
    "from_array",
    "mutable",
    "PipeError",
    "AllocationError",
    "StartError",
    "FlushError",
    "RunError",
    "ErrorRun",
    "Source",
    "Processor",
    "Sink",
    "SourceAllocatorFunc",
    "ProcessorAllocatorFunc",
    "SinkAllocatorFunc",
    "Line",
    "Processors",
    "Pipe",
    "run",
    "wait",
    "StatsRecorder",
    "trace",
    "process",
    "checkpoint",
]
