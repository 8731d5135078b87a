"""Blocking drivers (reference ``run.go:198-224`` and ``pipe.Run``,
``pipe.go:89-103``)."""

from __future__ import annotations

from typing import Optional

from pipe_tpu import mutable
from pipe_tpu.errors import ErrorRun, RunError, StartError
from pipe_tpu.graph import Line, make_route, make_routes_aggregated
from pipe_tpu.runtime.executor import EOF, LineExecutor, MultiLineExecutor


def run_executor(executor, cancel=None) -> None:
    """Run an executor to completion in the calling thread (``run.go:198-224``):
    start; loop execute until EOF/error; always flush; wrap exec+flush failures
    into :class:`ErrorRun`."""
    try:
        executor.start_hook()
    except Exception as e:  # noqa: BLE001
        if isinstance(e, StartError):
            raise
        err = StartError(f"error starting: {e}")
        err.__cause__ = e
        raise err from e

    err_exec: Optional[BaseException] = None
    try:
        while True:
            if cancel is not None and cancel.is_set():
                break
            stop_before = None
            if executor.dest is not None:
                frontier = executor.blocks_dispatched
                ms = executor.dest.take_due(frontier)
                if ms:
                    executor.apply_mutations(ms)
                stop_before = executor.dest.next_target(frontier)
            res = executor.execute(stop_before)
            if res is EOF:
                break
    except Exception as e:  # noqa: BLE001
        err_exec = RunError(f"error running: {e}")
        err_exec.__cause__ = e

    err_flush: Optional[BaseException] = None
    try:
        executor.flush_hook()
    except Exception as e:  # noqa: BLE001
        err_flush = e

    if err_exec is not None or err_flush is not None:
        raise ErrorRun(err_exec, err_flush)


def run(block_size: int, *lines: Line, stats=None, lookahead: int = 1,
        cancel=None, batch_blocks: int = 1, mesh=None,
        optimize: bool = False) -> None:
    """One-shot synchronous execution (``pipe.Run``, ``pipe.go:89-103``):
    every line is forced into one shared mutable context and round-robined by
    a single :class:`MultiLineExecutor` in the calling thread. ``stats`` is
    an optional :class:`pipe_tpu.StatsRecorder`; ``cancel`` an optional
    ``threading.Event`` — setting it (e.g. from another thread or a signal
    handler) stops the run at the next block boundary with flush hooks run,
    the analog of the reference's ctx argument (``pipe.go:90``).
    ``batch_blocks=k`` compiles a k-block ``lax.scan`` per dispatch for
    device-source lines — one dispatch advances k blocks (amortizes per-call
    overhead; mutation granularity coarsens to k).
    ``mesh`` shard_maps every line's step over a device mesh, exactly as
    ``Pipe(..., mesh=)`` — ``block_size`` is then the global chunk.
    ``optimize=True`` runs the algebraic fusion fixpoint
    (``pipe_tpu.optimize.fuse``) on every line before building — retunes
    on the original objects keep working through delegates."""
    from pipe_tpu.parallel.meshctx import mesh_scope

    if optimize:
        from pipe_tpu import optimize as _optimize

        lines = tuple(_optimize.fuse(line) for line in lines)
    mctx = mutable.mutable()
    mle = MultiLineExecutor(context=mctx)
    bound_lines = [
        Line(
            source=line.source,
            processors=line.processors,
            sink=line.sink,
            context=mctx,
        )
        for line in lines
    ]
    with mesh_scope(mesh):
        if mesh is None:
            routes = [make_route(b, block_size) for b in bound_lines]
            internal = block_size
        else:
            # any-block-size contract: aggregate user blocks until every
            # stage's shape rule holds (graph.make_routes_aggregated)
            routes, agg = make_routes_aggregated(bound_lines, block_size, mesh)
            internal = agg * block_size
    for i, route in enumerate(routes):
        ls = None
        if stats is not None:
            ls = stats.line(
                f"line{i}", internal, route.source.output.channels
            )
        mle.executors.append(
            LineExecutor(route, internal, stats=ls, lookahead=lookahead,
                         batch_blocks=batch_blocks, mesh=mesh)
        )
    run_executor(mle, cancel=cancel)
