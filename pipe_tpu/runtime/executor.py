"""Executors — the per-block hot path.

The reference executes one buffer per component per sweep, with goroutines
and channels between stages (``run.go:38-52``, ``pipe.go:381-471``). Here the
whole ``Source -> Processors -> Sink`` sweep for one block is ONE jitted XLA
computation built by :meth:`LineExecutor._build_step`: XLA fuses the stage
chain, so the inter-stage "transport" is device-memory dataflow, not
channels.

EOF protocol: the source step returns a traced ``eof`` bool. The executor
gates every component's state update on ``not eof`` inside the jitted step
(so a traced-past-EOF block is a no-op) and reads the flag back on the host
to terminate the stream — the analog of ``io.EOF`` propagating through the
line sweep (``run.go:44-47``).

:class:`MultiLineExecutor` round-robins several line executors in one driver
thread, flushing and splicing out lines as they hit EOF, exactly as the
reference's sync mode does (``run.go:113-132``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pipe_tpu import mutable
from pipe_tpu.errors import FlushError, StartError, ret_exec_errors
from pipe_tpu.graph import Route
from pipe_tpu.signal import Signal


class _EOF:
    """Sentinel returned by ``execute`` when the stream is done."""

    def __repr__(self):
        return "EOF"


EOF = _EOF()


def _gate(valid, new_tree, old_tree):
    """Select ``new_tree`` where ``valid`` else ``old_tree`` leafwise —
    the structural guard that nothing advances past EOF."""
    return jax.tree.map(lambda n, o: jnp.where(valid, n, o), new_tree, old_tree)


def _trees_compatible(a, b) -> bool:
    la, da = jax.tree.flatten(a)
    lb, db = jax.tree.flatten(b)
    return (
        da == db
        and len(la) == len(lb)
        and all(
            jnp.shape(x) == jnp.shape(y)
            and jnp.result_type(x) == jnp.result_type(y)
            for x, y in zip(la, lb)
        )
    )


def _carry_forward(old, new) -> None:
    """Carry the live state/params from a component onto its re-allocated
    replacement (width-changing live insert rebuilds everything
    downstream): state carries whole when the tree structure and every
    leaf shape/dtype match (filter tails, IIR states — exact, no
    transient); params carry per key so live retunes survive the rebuild.
    A leaf whose shape changed with the width keeps its fresh allocation
    — a one-block transient, documented in the surgery contract."""
    if _trees_compatible(old.state, new.state):
        new.state = old.state
    if isinstance(old.params, dict) and isinstance(new.params, dict):
        for k, v in new.params.items():
            if k in old.params and _trees_compatible(old.params[k], v):
                new.params[k] = old.params[k]


class LineExecutor:
    """Executes one bound line, one block per :meth:`execute` call.

    Keeps the live component states (device pytrees) and host-owned params;
    rebuilds + recompiles its fused step when the route changes (live
    InsertProcessor) — the recompile happens at a block boundary so no sample
    is lost or duplicated.
    """

    def __init__(self, route: Route, block_size: int, stats=None, lookahead: int = 1,
                 batch_blocks: int = 1, mesh=None):
        self.route = route
        self.block_size = block_size
        # Device mesh: when set, the fused line step is shard_map'ed over it
        # (channels x time) and component state/params shard by each
        # component's declared PartitionSpec trees — the sharded-execution
        # path behind the same Line/Pipe API (SURVEY §2 parallelism table).
        self.mesh = mesh
        self.started = 0  # how many components started, for rollback flush
        # compiled steps, built lazily: 'single' (one block), 'scan'
        # (batch_blocks device-source blocks per dispatch), 'scan_fed'
        # (batch_blocks host-fed blocks per dispatch)
        self._compiled: dict = {}
        # dispatch frontier: stream index of the next block to dispatch —
        # the coordinate system of block-indexed mutations
        self.blocks_dispatched = 0
        # Destination assigned by the runtime for async lines (the sync-group
        # destination lives on the MultiLineExecutor and is mirrored here
        # as ``group_dest`` so batched feed collection can re-check for
        # targets that arrive while a feed call blocks).
        self.dest: Optional[mutable.Destination] = None
        self.group_dest: Optional[mutable.Destination] = None
        # Opt-in per-block timing (pipe_tpu.profiling.LineStats); None = off.
        self.stats = stats
        # Dispatch pipelining: keep up to `lookahead` blocks in flight before
        # forcing the EOF flag / sink output of the oldest one. JAX dispatch
        # is async, so with lookahead > 1 the host round-trip per block
        # overlaps with device compute.
        # Safe to speculate past EOF: every state update is gated on ~eof
        # inside the jitted step, so extra blocks are no-ops. A pushed
        # mutation still lands at a block boundary, but up to `lookahead`
        # blocks later than the reference's next-buffer guarantee — hence
        # the default of 1 (exact reference semantics).
        self.lookahead = max(1, lookahead)
        # Dispatch batching: compile a lax.scan over `batch_blocks` blocks so
        # ONE dispatch advances the stream by k blocks — amortizes per-call
        # overhead. Only applies to
        # device-source lines (a host `feed` callback must run per block);
        # mutation granularity coarsens to k blocks, like lookahead. k=1 is
        # exact reference semantics.
        self.batch_blocks = max(1, batch_blocks)
        self._pending: list = []  # in-flight resolution entries, oldest first
        self._held_feds: list = []  # fed blocks parked behind a target
        self._fed_eof = False  # feed returned None (held blocks may remain)
        # Mesh re-chunking (short-read protocol, reference pipe.go:404-406):
        # (C, n) pieces of feed data not yet forming a full block.
        self._fed_residue: list = []

    # -- step construction ------------------------------------------------

    def _invalidate(self):
        self._compiled = {}

    def compile_counts(self) -> int:
        """Total compiled-variant count across the step cache (test/diag
        hook for the zero-recompile guarantee)."""
        return sum(fn._cache_size() for fn in self._compiled.values())

    # -- mesh (sharded) helpers ---------------------------------------------

    @staticmethod
    def _spec_like(tree, explicit):
        """A PartitionSpec tree for ``tree``: the component's declared spec,
        or fully replicated when none is declared."""
        from jax.sharding import PartitionSpec as P

        if explicit is not None:
            return explicit
        return jax.tree.map(lambda _: P(), tree)

    def _component_specs(self):
        comps = self.route.components()
        state_specs = []
        param_specs = []
        for c in comps:
            state_specs.append(self._spec_like(c.state, getattr(c, "state_spec", None)))
            param_specs.append(self._spec_like(c.params, getattr(c, "param_spec", None)))
        src_s, *proc_s, sink_s = state_specs
        src_p, *proc_p, sink_p = param_specs
        return (
            (src_s, tuple(proc_s), sink_s),
            (src_p, tuple(proc_p), sink_p),
        )

    def _validate_mesh_route(self):
        from pipe_tpu.parallel.mesh import CH_AXIS, TIME_AXIS

        t_shards = self.mesh.shape[TIME_AXIS]
        ch_shards = self.mesh.shape[CH_AXIS]
        if self.block_size % t_shards:
            raise ValueError(
                f"block_size {self.block_size} not divisible by the mesh "
                f"time axis ({t_shards})"
            )
        if t_shards > 1:
            for c in self.route.components():
                if jax.tree.leaves(c.state) and not hasattr(c, "state_spec"):
                    raise ValueError(
                        f"stateful component {c!r} has no state_spec: on a "
                        "time-sharded mesh, stream state must declare its "
                        "sharding (use the pipe_tpu.parallel.components kit "
                        "or set state_spec/param_spec explicitly)"
                    )

    @property
    def _multiprocess(self) -> bool:
        """True when the mesh spans multiple processes (multi-host): host
        arrays must then be assembled per-process (device_put cannot target
        non-addressable devices) and host-visible outputs are replicated so
        every host's sink sees the whole stream."""
        return self.mesh is not None and jax.process_count() > 1

    @property
    def _c_pad(self) -> int:
        """Host-fed channel rows padded to the mesh channel-axis multiple
        (zero rows end to end; sliced off before the sink)."""
        c = self.route.source.output.channels
        if self.mesh is None:
            return c
        from pipe_tpu.parallel.mesh import CH_AXIS

        ch = self.mesh.shape[CH_AXIS]
        return -(-c // ch) * ch

    def _put_global(self, value, spec):
        """Place a host array with a mesh sharding — every process holds
        the identical global value; on multi-host only the addressable
        shards are materialized."""
        from jax.sharding import NamedSharding

        sharding = NamedSharding(self.mesh, spec)
        value = np.asarray(value)
        if not self._multiprocess:
            return jax.device_put(value, sharding)
        return jax.make_array_from_callback(
            value.shape, sharding, lambda idx: value[idx]
        )

    def _place_states(self):
        """Pre-place component states with their run-time NamedSharding so
        the first step's donation can alias them (a freshly-created
        unsharded array cannot back a sharded output buffer)."""
        for c in self.route.components():
            spec = self._spec_like(c.state, getattr(c, "state_spec", None))
            leaves, treedef = jax.tree.flatten(c.state)
            if not leaves:
                continue
            specs = treedef.flatten_up_to(spec)
            c.state = treedef.unflatten(
                [self._put_global(l, s) for l, s in zip(leaves, specs)]
            )

    def _make_inner(self):
        """The single-block traced step ``inner(states, params, fed) ->
        (states, (out_data, out_frames) | None, eof)`` — the whole
        Source -> Processors -> Sink sweep fused into one computation
        (reference hot loop ``run.go:215-217`` -> ``pipe.go:381-471``).
        ``fed`` is ``(data, frames)`` for host-fed lines, else None.

        On a mesh the same function body runs INSIDE shard_map: component
        steps see local shards and use halo collectives; the executor masks
        source data past the global valid count by each device's global
        positions (the EOF / partial-final-chunk protocol)."""
        src = self.route.source
        procs = list(self.route.processors)
        sink = self.route.sink
        has_feed = src.feed is not None
        want_out = sink.receive is not None
        has_dev_sink = sink.step is not None
        local = self.mesh is not None
        if local:
            from pipe_tpu.parallel.mesh import TIME_AXIS

            n_local_in = self.block_size // self.mesh.shape[TIME_AXIS]
        c_user = src.output.channels
        pad_src_rows = local and not has_feed and self._c_pad != c_user
        # multi-host: gather the host-visible output inside the step so
        # every host's sink sees the whole stream (out_specs are then fully
        # replicated — a host cannot read other hosts' shards)
        gather_out = local and want_out and self._multiprocess
        gather_ch = not any(
            getattr(p, "reduces_channels", False) for p in procs
        )

        def inner(states, params, fed):
            src_state, proc_states, sink_state = states
            src_params, proc_params, sink_params = params

            if has_feed:
                data, frames = fed
                eof = jnp.asarray(False)
            else:
                new_src_state, sig, eof = src.step(src_state, src_params)
                data, frames = sig.data, sig.frames
                eof = jnp.asarray(eof, bool)
                src_state = _gate(~eof, new_src_state, src_state)
                if local and pad_src_rows:
                    # device source on a channel-padded line: the step
                    # generates ceil(C/ch_shards) local rows; zero the pad
                    # rows (global row >= C) so they stay inert end to end
                    # — the device twin of _prep_fed_host's zero staging
                    # rows (r4 channel-padding contract, all sources now)
                    from pipe_tpu.parallel.mesh import CH_AXIS

                    row = jax.lax.axis_index(CH_AXIS) * data.shape[
                        0
                    ] + jnp.arange(data.shape[0], dtype=jnp.int32)
                    data = jnp.where(row[:, None] < c_user, data, 0.0)

            if local:
                # zero everything past the global valid count so stage math
                # past the stream end is inert; each device masks by its
                # GLOBAL positions
                from pipe_tpu.parallel.mesh import TIME_AXIS

                start = jax.lax.axis_index(TIME_AXIS) * n_local_in
                idx = start + jnp.arange(data.shape[1], dtype=jnp.int32)
                data = jnp.where(idx[None, :] < frames, data, 0.0)
            sig = Signal(data, frames)

            valid = ~eof
            new_proc_states = []
            for proc, pstate, pparams in zip(procs, proc_states, proc_params):
                new_pstate, sig = proc.step(pstate, pparams, sig)
                new_proc_states.append(_gate(valid, new_pstate, pstate))

            if has_dev_sink:
                new_sink_state = sink.step(sink_state, sink_params, sig)
                sink_state = _gate(valid, new_sink_state, sink_state)

            if want_out:
                d = sig.data
                if gather_out:
                    from pipe_tpu.parallel.mesh import CH_AXIS, TIME_AXIS

                    # gather on a NEW leading axis, then transpose+reshape
                    # to the tiled layout: equivalent to
                    # all_gather(axis=1, tiled=True), but the tiled form
                    # makes XLA:CPU's multi-process layout assignment feed
                    # upstream fft ops a transposed layout its fft thunk
                    # RET_CHECKs on (fft_thunk.cc:167; seen with the
                    # distributed-FDL OLS ahead of this gather)
                    g0 = jax.lax.all_gather(d, TIME_AXIS, axis=0, tiled=False)
                    d = jnp.transpose(g0, (1, 0, 2)).reshape(
                        d.shape[0], -1
                    )
                    if gather_ch:
                        d = jax.lax.all_gather(d, CH_AXIS, axis=0, tiled=True)
                out = (d, sig.frames)
            else:
                out = None
            return (src_state, tuple(new_proc_states), sink_state), out, eof

        return inner

    @staticmethod
    def _make_scan(inner, k: int, consumes_fed: bool):
        """Scan ``k`` blocks per dispatch; outputs stack on a leading axis.
        States are gated on ~eof inside ``inner``, so blocks scanned past
        EOF are no-ops and the host drops them at resolution. When
        ``consumes_fed``, the scan consumes a stacked (k, ...) fed batch —
        host-fed lines get the same one-dispatch-per-k-blocks amortization
        as device sources."""

        def scanned(states, params, fed):
            def body(carry, fed_elt):
                new_states, out, eof = inner(carry, params, fed_elt)
                return new_states, (out if out is not None else (), eof)

            xs = fed if consumes_fed else None
            states, (outs, eofs) = jax.lax.scan(
                body, states, xs, length=None if consumes_fed else k
            )
            return states, outs, eofs

        return scanned

    def _get_step(self, kind: str):
        """Fetch (compile on first use) a step variant: 'single', 'scan'
        (device-source k-batch), 'scan_fed' (host-fed k-batch). Old states
        are dead after each step, so their buffers are donated — the
        pool-allocator analog (reference pipe.go:490-492)."""
        fn = self._compiled.get(kind)
        if fn is not None:
            return fn
        inner = self._make_inner()
        k = self.batch_blocks
        if self.mesh is None:
            if kind == "single":
                fn = jax.jit(inner, donate_argnums=(0,))
            else:
                fn = jax.jit(
                    self._make_scan(inner, k, consumes_fed=kind == "scan_fed"),
                    donate_argnums=(0,),
                )
        else:
            fn = self._shard_mapped_step(inner, kind, k)
        self._compiled[kind] = fn
        return fn

    def _shard_mapped_step(self, inner, kind: str, k: int):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from pipe_tpu.parallel.mesh import CH_AXIS, TIME_AXIS

        self._validate_mesh_route()
        self._place_states()

        want_out = self.route.sink.receive is not None
        state_specs, param_specs = self._component_specs()
        # the signal is channel-sharded until a channel-reducing stage
        # (psum mixer) replicates it over the channel axis
        out_ch = CH_AXIS
        for p in self.route.processors:
            if getattr(p, "reduces_channels", False):
                out_ch = None
        out_time = TIME_AXIS
        if self._multiprocess and want_out:
            # multi-host: replicate the host-visible output so every host's
            # sink receives the full stream (a host cannot read shards on
            # other hosts' devices)
            out_ch = None
            out_time = None

        if kind == "single":
            fed_spec = (
                (P(CH_AXIS, TIME_AXIS), P())
                if self.route.source.feed is not None
                else None
            )
            out_spec = (P(out_ch, out_time), P()) if want_out else None
            mapped = shard_map(
                inner,
                mesh=self.mesh,
                in_specs=(state_specs, param_specs, fed_spec),
                out_specs=(state_specs, out_spec, P()),
                check_vma=False,
            )
        else:
            consumes_fed = kind == "scan_fed"
            fed_spec = (
                (P(None, CH_AXIS, TIME_AXIS), P(None)) if consumes_fed else None
            )
            out_spec = (
                (P(None, out_ch, out_time), P(None)) if want_out else ()
            )
            mapped = shard_map(
                self._make_scan(inner, k, consumes_fed),
                mesh=self.mesh,
                in_specs=(state_specs, param_specs, fed_spec),
                out_specs=(state_specs, out_spec, P(None)),
                check_vma=False,
            )
        return jax.jit(mapped, donate_argnums=(0,))

    def _states(self):
        return (
            self.route.source.state,
            tuple(p.state for p in self.route.processors),
            self.route.sink.state,
        )

    def _params(self):
        return (
            self.route.source.params,
            tuple(p.params for p in self.route.processors),
            self.route.sink.params,
        )

    def _writeback(self, states):
        src_state, proc_states, sink_state = states
        self.route.source.state = src_state
        for p, s in zip(self.route.processors, proc_states):
            p.state = s
        self.route.sink.state = sink_state

    # -- hot path ----------------------------------------------------------

    def execute(self, stop_before=None):
        """Advance the line by one dispatch (one block, or ``batch_blocks``
        blocks). Returns :data:`EOF` when the stream is done, else None.
        Raises on component failure. ``stop_before`` caps the dispatch at
        that absolute block index so mutations land exactly there."""
        if self.stats is None:
            return self._execute(stop_before)
        from pipe_tpu.profiling import _Timer

        with _Timer(self.stats):
            return self._execute(stop_before)

    def _execute(self, stop_before=None):
        """Dispatch up to ``batch_blocks`` blocks. ``stop_before`` caps the
        dispatch at that absolute block index (exclusive) so a block-indexed
        mutation can land exactly there: the caller applies due mutations
        between dispatches, and this method never crosses the boundary."""
        src = self.route.source

        # Host-side pre hooks in stage order (fault injection, pacing).
        for comp in self.route.components():
            if comp.host_pre is not None:
                comp.host_pre()

        k = self.batch_blocks
        budget = k
        if stop_before is not None:
            budget = max(1, min(k, stop_before - self.blocks_dispatched))

        if src.feed is not None:
            res = self._dispatch_fed(budget)
        else:
            res = self._dispatch_device(budget)
        if res is EOF:
            return EOF
        if len(self._pending) >= self.lookahead:
            # Resolve half the window in ONE host transfer: fetching each
            # block's flag individually would cost one device->host round
            # trip per block, which defeats the pipelining.
            # A split dispatch (stop_before) can enqueue several SINGLE
            # entries per execute, so also resolve whatever exceeds the
            # window — the in-flight depth must stay bounded by lookahead.
            n = max(
                1,
                self.lookahead // 2,
                len(self._pending) - self.lookahead + 1,
            )
            return self._resolve_batch(n)
        return None

    def _prep_fed_host(self, data):
        """Normalize one host feed result to (padded (C, block) float32,
        valid frame count)."""
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[None, :]
        n = data.shape[1]
        c_pad = self._c_pad
        if n < self.block_size or data.shape[0] < c_pad:
            # one zero staging buffer covers both the partial-block column
            # pad and the channel row pad (single copy on the hot path)
            out = np.zeros((c_pad, self.block_size), np.float32)
            out[: data.shape[0], :n] = data
            return out, n
        return np.asarray(data, np.float32), n

    def _fed_to_device(self, data, frames, stacked: bool):
        if self.mesh is None:
            return jnp.asarray(data), jnp.asarray(frames, jnp.int32)
        from jax.sharding import PartitionSpec as P

        from pipe_tpu.parallel.mesh import CH_AXIS, TIME_AXIS

        d_spec = (
            P(None, CH_AXIS, TIME_AXIS) if stacked else P(CH_AXIS, TIME_AXIS)
        )
        f_spec = P(None) if stacked else P()
        return (
            self._put_global(data, d_spec),
            self._put_global(np.asarray(frames, np.int32), f_spec),
        )

    def _feed_full_block(self, src):
        """Assemble one FULL block (or the final partial at EOF) from the
        feed, parking over- and under-runs in ``_fed_residue`` — the mesh
        twin of the reference's accept-any-length short-read slicing
        (``pipe.go:404-406``). Returns ``None`` at EOF with nothing left,
        else ``(padded (C, block) float32, valid frames)``. Deterministic
        host-side repacking, so multi-host symmetric feeds stay aligned."""
        have = sum(a.shape[1] for a in self._fed_residue)
        while have < self.block_size and not self._fed_eof:
            data = src.feed(self.block_size - have)
            if data is None:
                self._fed_eof = True
                break
            data = np.asarray(data, np.float32)
            if data.ndim == 1:
                data = data[None, :]
            if data.shape[1] == 0:
                continue  # empty read: ask again (progress is the feed's
                # contract, as in the non-mesh zero-frame no-op block)
            self._fed_residue.append(data)
            have += data.shape[1]
        if have == 0:
            return None
        n = min(have, self.block_size)
        chunks, taken = [], 0
        while taken < n:
            a = self._fed_residue[0]
            take = min(a.shape[1], n - taken)
            chunks.append(a[:, :take])
            if take < a.shape[1]:
                self._fed_residue[0] = a[:, take:]
            else:
                self._fed_residue.pop(0)
            taken += take
        data = chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=1)
        return self._prep_fed_host(data)

    def _next_target(self, frontier: int):
        """The nearest pending block target past ``frontier``, from the
        owning destination (async: own; sync group: mirrored)."""
        d = self.dest or self.group_dest
        return d.next_target(frontier) if d is not None else None

    def _dispatch_fed(self, budget: int):
        """Collect up to ``budget`` host-fed blocks and dispatch them: a full
        batch as ONE scanned dispatch, a remainder as single steps. The
        feed's EOF (None) drains everything in flight so trailing blocks
        reach the sink before the stream ends.

        The budget is RE-CAPPED against the nearest pending block target
        before every feed call: a ``feed`` may block for arbitrarily long
        (a gated/slow source), and a target pushed during that window must
        still split the batch — the budget computed at ``execute()`` entry
        is stale by then (r4 soak finding; exact-landing contract)."""
        src = self.route.source
        feds = []
        while len(feds) < budget:
            nt = self._next_target(self.blocks_dispatched)
            if (
                nt is not None
                and self.blocks_dispatched + len(feds) >= nt
            ):
                break  # stop at the target; the outer loop applies it
            if self._held_feds:
                # blocks collected past a target in an earlier call
                feds.append(self._held_feds.pop(0))
                continue
            if self._fed_eof and not self._fed_residue:
                break  # feed already returned None; only held blocks left
            if self.mesh is not None:
                # Sharded stages advance their carries by whole local
                # chunks (the streaming ops slice at sig.frames; the
                # sharded twins cannot — a shard's tail would live on
                # another device), so a partial block must be the stream's
                # LAST on a mesh. The reference's short-read protocol lets
                # a source return fewer frames at ANY point
                # (pipe.go:404-406, mock/mock.go:95-105) — so re-chunk
                # host-side: park short reads and dispatch only full
                # blocks until EOF. Exact: repacking changes no sample
                # values, only where the block boundaries fall.
                got = self._feed_full_block(src)
                if got is None:
                    break  # EOF with no residue (self._fed_eof now set)
                feds.append(got)
                if got[1] < self.block_size:
                    break  # final partial at EOF
                continue
            data = src.feed(self.block_size)
            if data is None:
                self._fed_eof = True
                break
            feds.append(self._prep_fed_host(data))
            if feds[-1][1] < self.block_size:
                break  # partial block: dispatch it alone (streaming ops
                # carry hop residues exactly; keep batches full-block)
        # a target may have arrived DURING the last blocking feed call,
        # landing inside the already-collected range: dispatch only up to
        # it and hold the rest for the next execute (after the outer loop
        # applies the mutation) — collected blocks cannot go back to the
        # feed, but they can wait
        nt = self._next_target(self.blocks_dispatched)
        if nt is not None and self.blocks_dispatched + len(feds) > nt:
            keep = nt - self.blocks_dispatched
            self._held_feds = feds[keep:] + self._held_feds
            feds = feds[:keep]
        if feds:
            if len(feds) == self.batch_blocks and self.batch_blocks > 1:
                fed = self._fed_to_device(
                    np.stack([d for d, _ in feds]),
                    np.asarray([n for _, n in feds], np.int32),
                    stacked=True,
                )
                states, outs, eofs = self._get_step("scan_fed")(
                    self._states(), self._params(), fed
                )
                self._writeback(states)
                self.blocks_dispatched += len(feds)
                self._pending.append((outs if outs else None, eofs, True))
                if self.stats is not None:
                    self.stats.blocks += len(feds) - 1
            else:
                step1 = self._get_step("single")
                for data, n in feds:
                    fed = self._fed_to_device(data, n, stacked=False)
                    states, out, eof = step1(
                        self._states(), self._params(), fed
                    )
                    self._writeback(states)
                    self.blocks_dispatched += 1
                    self._pending.append((out, eof, False))
                if self.stats is not None:
                    self.stats.blocks += len(feds) - 1
        if self._fed_eof and not self._held_feds and not self._fed_residue:
            self.drain()
            return EOF
        return None

    def _dispatch_device(self, budget: int):
        if budget == self.batch_blocks and self.batch_blocks > 1:
            states, outs, eofs = self._get_step("scan")(
                self._states(), self._params(), None
            )
            self._writeback(states)
            self.blocks_dispatched += budget
            self._pending.append((outs if outs else None, eofs, True))
            if self.stats is not None:
                self.stats.blocks += budget - 1
        else:
            step1 = self._get_step("single")
            for _ in range(budget):
                states, out, eof = step1(self._states(), self._params(), None)
                self._writeback(states)
                self.blocks_dispatched += 1
                self._pending.append((out, eof, False))
            if self.stats is not None:
                self.stats.blocks += budget - 1
        return None

    def _resolve_batch(self, k: int):
        """Force the ``k`` oldest in-flight entries with a single
        ``jax.device_get``, then deliver outputs/EOF in stream order. An
        entry is one block, or ``batch_blocks`` stacked blocks from a
        scanned dispatch."""
        sink = self.route.sink
        batch, self._pending = self._pending[:k], self._pending[k:]
        want_out = sink.receive is not None
        fetched = jax.device_get([(out, eof) for out, eof, _ in batch])
        for (out, eof), (_, _, stacked) in zip(fetched, batch):
            if not stacked:
                blocks = [(bool(eof), out)]
            else:
                n_blk = np.shape(eof)[0]
                blocks = [
                    (
                        bool(eof[j]),
                        (out[0][j], out[1][j]) if out is not None else None,
                    )
                    for j in range(n_blk)
                ]
            for done, blk in blocks:
                if done:
                    # blocks dispatched/scanned after EOF are gated no-ops
                    self._pending.clear()
                    return EOF
                if want_out and blk is not None:
                    data, frames = blk
                    n = int(frames)
                    if n > 0:
                        # slice off channel pad rows (host-fed mesh lines)
                        c_out = self.route.prev_props(
                            len(self.route.processors)
                        ).channels
                        sink.receive(data[:c_out, :n])
        return None

    def dispatch_noop_to(self, target: int):
        """Exit-path padding (multi-host protocol,
        ``pipe_tpu.parallel.hostsync``): issue single-block no-op
        dispatches until the device-dispatch frontier reaches ``target``,
        mirroring a regular dispatch's cross-host collectives so peers'
        in-flight chunks complete instead of hanging. Component state is
        FULLY preserved: the donated step runs on copies of the states and
        every output is discarded — nothing reaches the sink, nothing is
        written back (a subsequent checkpoint.snapshot sees the exact
        pre-exit stream state, identical on every host)."""
        src = self.route.source
        step1 = self._get_step("single")
        while self.blocks_dispatched < target:
            states = jax.tree.map(jnp.copy, self._states())  # donation-safe
            if src.feed is not None:
                fed = self._fed_to_device(
                    np.zeros((self._c_pad, self.block_size), np.float32), 0,
                    stacked=False,
                )
                step1(states, self._params(), fed)
            else:
                step1(states, self._params(), None)
            self.blocks_dispatched += 1

    def drain(self):
        """Resolve every in-flight block (normal end-of-stream and flush
        path) so no sample is lost. Returns EOF if one was found."""
        res = None
        while self._pending:
            r = self._resolve_batch(len(self._pending))
            if r is EOF:
                res = EOF
        return res

    # -- lifecycle (reference run.go:54-74) --------------------------------

    def start_hook(self):
        """Start components in order; stop at the first failure, remembering
        how many started so only those get flushed (``run.go:64-74``). A
        restart is a NEW stream: the dispatch frontier — the coordinate
        system of ``push(..., at_block=N)`` — rewinds to block 0."""
        self.blocks_dispatched = 0
        self._held_feds = []
        self._fed_eof = False
        self._fed_residue = []
        for comp in self.route.components():
            if comp.start is not None:
                comp.start()  # raises -> caller handles rollback
            self.started += 1

    def flush_hook(self):
        """Flush the started components in order, collecting every error
        (``run.go:54-62``). In-flight lookahead blocks are resolved first so
        a clean stop never drops delivered samples (on the error/cancel path
        resolution failures join the flush error set)."""
        errors = []
        try:
            self.drain()
        except Exception as e:  # noqa: BLE001 - fan-in semantics
            errors.append(e)
        for comp in self.route.components()[: self.started]:
            if comp.flush is not None:
                try:
                    comp.flush()
                except Exception as e:  # noqa: BLE001 - fan-in semantics
                    errors.append(e)
        # Reset for restart (a Pipe can be started again after completion,
        # reference pipe_test.go:108-131) and to make double-flush a no-op.
        self.started = 0
        err = ret_exec_errors(errors)
        if err is not None:
            raise FlushError(str(err)) from err

    # -- live surgery -------------------------------------------------------

    def insert_processor(self, pos: int, proc, alloc=None, rebuilt=None) -> None:
        """Splice a started processor into the route at ``pos`` and recompile
        at the next block boundary (the fused-step form of the reference's
        two-phase handoff, ``pipe.go:297-365`` / ``run.go:146-169``).

        ``rebuilt`` = ``(new_downstream_procs, new_sink)`` re-allocated for
        a new block width (a width-changing insert — resampler, STFT,
        channelizer): the swap happens HERE, at the block boundary in the
        executor thread, carrying each old component's live state/params
        onto its replacement where shapes match — so downstream tails
        continue exactly and live retunes survive."""
        if rebuilt is not None:
            new_after, new_sink = rebuilt
            for old, new in zip(self.route.processors[pos:], new_after):
                _carry_forward(old, new)
            _carry_forward(self.route.sink, new_sink)
            self.route.processors[pos:] = new_after
            self.route.sink = new_sink
        self.route.processors.insert(pos, proc)
        if alloc is not None:
            self.route.proc_allocs.insert(pos, alloc)
        self.started += 1
        self._invalidate()

    def apply_mutations(self, ms: mutable.Mutations) -> None:
        """Apply a delivered batch to this line's components in stage order
        (the reference applies in-band per stage, ``pipe.go:384-392,433,465``;
        block-boundary application is the same ordering at our buffer
        granularity)."""
        seen = set()
        for comp in self.route.components():
            if comp.context in seen:
                continue
            seen.add(comp.context)
            ms.apply_to(comp.context)


class MultiLineExecutor:
    """Round-robins multiple line executors in one driver thread
    (``run.go:28-34,113-132``). All lines share one mutable context and one
    mutation destination."""

    def __init__(
        self,
        context: mutable.Context = mutable.IMMUTABLE,
        dest: Optional[mutable.Destination] = None,
        executors: Optional[List[LineExecutor]] = None,
    ):
        self.context = context
        self.dest = dest
        self.executors: List[LineExecutor] = executors or []

    def start_hook(self):
        """Start every line; on failure flush everything already started and
        raise (``run.go:78-99``)."""
        start_err = None
        for le in self.executors:
            try:
                le.start_hook()
            except Exception as e:  # noqa: BLE001
                start_err = e
                break
        if start_err is None:
            return
        err = StartError(f"error starting lines: {start_err}")
        err.__cause__ = start_err
        try:
            self.flush_hook()
        except Exception as flush_err:  # noqa: BLE001
            err = StartError(
                f"error flushing lines: {flush_err} during start error: {start_err}"
            )
            err.__cause__ = flush_err
        raise err

    def flush_hook(self):
        errors = []
        for le in self.executors:
            try:
                le.flush_hook()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        err = ret_exec_errors(errors)
        if err is not None:
            raise err

    @property
    def blocks_dispatched(self) -> int:
        """The group's dispatch frontier: lines in a sync group advance in
        lockstep, so the max over live lines is the sweep coordinate used by
        block-indexed mutations (live-added lines start behind)."""
        return max((le.blocks_dispatched for le in self.executors), default=0)

    def execute(self, stop_before=None):
        """One sweep over all live lines; EOF'd lines are flushed and spliced
        out; returns EOF once no lines remain (``run.go:113-132``)."""
        i = 0
        while i < len(self.executors):
            res = self.executors[i].execute(stop_before)  # raises on error
            if res is EOF:
                self.executors[i].flush_hook()  # raises -> becomes the error
                del self.executors[i]
                if self.executors:
                    continue
                return EOF
            i += 1
        return None

    def apply_mutations(self, ms: mutable.Mutations) -> None:
        for le in self.executors:
            le.apply_mutations(ms)

    def dispatch_noop_to(self, target: int) -> None:
        # Each line pads to the SAME frontier (after a mid-sweep failure
        # the lines may be unevenly dispatched, and peers' per-line
        # collective counts must match ours line by line) — and in SWEEP
        # ORDER, interleaving lines exactly like a normal round-robin
        # pass, so the enqueue order of the per-line collectives matches
        # the still-streaming peers' order (a whole-line-at-a-time pad
        # could deadlock two device queues against each other).
        while any(le.blocks_dispatched < target for le in self.executors):
            for le in self.executors:
                if le.blocks_dispatched < target:
                    le.dispatch_noop_to(le.blocks_dispatched + 1)

    def adopt_line(self, le: LineExecutor) -> None:
        """Start and append a new line at a block boundary (the analog of
        ``multiLineExecutor.addRoute``, ``run.go:134-144``)."""
        le.start_hook()  # raises -> delivered as executor error
        self.executors.append(le)
