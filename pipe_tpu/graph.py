"""Graph construction — Lines and Routes (reference ``line.go``).

A :class:`Line` is the declarative form: allocator functions for one source,
zero or more processors, and one sink, plus an optional shared mutable
context. Binding a line (:func:`make_route`) runs the allocators in order,
threading :class:`SignalProperties` source -> processors -> sink exactly as
``line.go:62-90`` does, and wraps allocator failures with the stage name.

Execution-mode selection mirrors ``line.go:92-104`` at one level up: lines
with a mutable context form *sync groups* (one executor thread round-robins
them, reference ``run.go:28-34``); immutable lines are *async* (own thread).
The intra-line stage chain always fuses into one jitted computation —
the Sync/Async fitting distinction of the reference collapses because there
is no per-stage goroutine to connect.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from pipe_tpu import mutable
from pipe_tpu.components import (
    Processor,
    ProcessorAllocatorFunc,
    Sink,
    SinkAllocatorFunc,
    Source,
    SourceAllocatorFunc,
)
from pipe_tpu.errors import AllocationError
from pipe_tpu.signal import SignalProperties


@dataclasses.dataclass
class Line:
    """Sequence of DSP component allocators (``line.go:14-19``)."""

    source: SourceAllocatorFunc
    sink: SinkAllocatorFunc
    processors: Sequence[ProcessorAllocatorFunc] = ()
    context: mutable.Context = mutable.IMMUTABLE


def Processors(*processors: ProcessorAllocatorFunc) -> List[ProcessorAllocatorFunc]:
    """Helper for line literals (``pipe.go:367-370``)."""
    return list(processors)


@dataclasses.dataclass
class Route:
    """A bound line: allocated components ready to execute
    (``line.go:44-49``)."""

    context: mutable.Context
    source: Source
    processors: List[Processor]
    sink: Sink
    # The allocator funcs the components came from, kept so live surgery
    # can RE-ALLOCATE downstream stages when a width-changing processor
    # is inserted (the reference's InsertProcessor hands any allocator
    # the predecessor's properties and rebuilds nothing because its
    # buffers are per-message; our static shapes rebuild instead —
    # ``pipe.go:297-312``).
    proc_allocs: List[ProcessorAllocatorFunc] = dataclasses.field(
        default_factory=list
    )
    sink_alloc: Optional[SinkAllocatorFunc] = None

    def components(self):
        return [self.source, *self.processors, self.sink]

    def prev_props(self, pos: int) -> SignalProperties:
        """Output properties of the component preceding processor slot
        ``pos`` (``line.go:120-126``) — used by live InsertProcessor."""
        if pos == 0:
            return self.source.output
        return self.processors[pos - 1].output

    def prev_capacity(self, pos: int, block_size: int) -> int:
        """Input block WIDTH at processor slot ``pos``: the pipe block
        threaded through any upstream width-changing ops (the live
        InsertProcessor twin of make_route's width threading)."""
        width = block_size
        for proc in self.processors[:pos]:
            if proc.out_capacity is not None:
                width = proc.out_capacity
        return width


def component_context(line_ctx: mutable.Context) -> mutable.Context:
    """Sync lines share the line context; async components each get a fresh
    one (``line.go:160-165``)."""
    if line_ctx.is_mutable():
        return line_ctx
    return mutable.mutable()


def allocate_source(
    alloc: SourceAllocatorFunc, ctx: mutable.Context, block_size: int
) -> Source:
    src = alloc(ctx, block_size)
    src.context = ctx
    return src


def allocate_processor(
    alloc: ProcessorAllocatorFunc,
    ctx: mutable.Context,
    block_size: int,
    input_props: SignalProperties,
) -> Processor:
    proc = alloc(ctx, block_size, input_props)
    proc.context = ctx
    return proc


def allocate_sink(
    alloc: SinkAllocatorFunc,
    ctx: mutable.Context,
    block_size: int,
    input_props: SignalProperties,
) -> Sink:
    sink = alloc(ctx, block_size, input_props)
    sink.context = ctx
    return sink


def make_routes_aggregated(
    lines: Sequence[Line], block_size: int, mesh, max_agg: int = 4096
):
    """Bind lines for a mesh pipe at the smallest BLOCK AGGREGATION factor
    ``a`` whose internal block ``a * block_size`` satisfies every stage's
    shape rules (time-axis divisibility, halo <= n_local, resampler phase,
    spectral grids) — the any-block-size contract of the reference
    (``pipe.go:90``; r4, VERDICT r3 item 3). One dispatch then advances
    ``a`` user blocks; chunking is stream-transparent, so the output is
    sample-exact for ANY block size, at the cost of a-block dispatch
    granularity (mutations land on the a-block grid).

    Returns ``(routes, a)``. Only :class:`~pipe_tpu.errors.ShapeConstraintError`
    allocation failures are retried at a larger ``a``; anything else
    propagates immediately.
    """
    from pipe_tpu.errors import ShapeConstraintError
    from pipe_tpu.parallel.mesh import TIME_AXIS

    t_shards = mesh.shape[TIME_AXIS]
    last_err: Optional[Exception] = None
    for a in range(1, max_agg + 1):
        if (a * block_size) % t_shards:
            continue
        try:
            routes = [make_route(line, a * block_size) for line in lines]
            return routes, a
        except AllocationError as e:
            if isinstance(e.__cause__, ShapeConstraintError):
                last_err = e
                continue
            raise
    raise AllocationError(
        f"no block aggregation factor up to {max_agg} satisfies every "
        f"stage's shape rules for block_size={block_size} on this mesh "
        f"(last failure: {last_err})"
    ) from last_err


def make_route(line: Line, block_size: int) -> Route:
    """Run the allocators in order, threading signal properties
    (``line.go:62-90``). Raises :class:`AllocationError` naming the stage."""
    try:
        source = allocate_source(line.source, component_context(line.context), block_size)
    except Exception as e:
        raise AllocationError(f"source: {e}") from e
    props = source.output

    processors: List[Processor] = []
    width = block_size  # per-stage input capacity (width-changing ops
    # declare out_capacity; everything downstream sizes to it)
    for alloc in line.processors:
        try:
            proc = allocate_processor(
                alloc, component_context(line.context), width, props
            )
        except Exception as e:
            raise AllocationError(f"processor: {e}") from e
        props = proc.output
        if proc.out_capacity is not None:
            width = proc.out_capacity
        processors.append(proc)

    try:
        sink = allocate_sink(line.sink, component_context(line.context), width, props)
    except Exception as e:
        raise AllocationError(f"sink: {e}") from e

    return Route(
        context=line.context,
        source=source,
        processors=processors,
        sink=sink,
        proc_allocs=list(line.processors),
        sink_alloc=line.sink,
    )
