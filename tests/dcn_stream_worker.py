"""Worker for the multi-host STREAMING tests (see test_distributed.py):
one of N identical processes running the full Pipe runtime over a global
mesh — chunk-after-chunk streaming with carried state across processes, a
block-indexed mutation landing on the same sample on every host, and
first-error-wins abort across the process group.

Usage: python dcn_stream_worker.py <mode> <process_id> <num_processes> <coordinator>
modes: stream | stream_untargeted | abort | abort_late | multiline | ckpt
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    mode, pid, nproc, coord = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )

    import numpy as np
    import scipy.signal

    import pipe_tpu
    from pipe_tpu import mock, ops, parallel
    from pipe_tpu.components import Source
    from pipe_tpu.signal import SignalProperties, snr_db

    parallel.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc

    # time axis spans ALL processes: the FIR halo crosses a process
    # boundary (the process edge) every single chunk
    mesh = parallel.make_global_mesh(channel_shards=1, time_shards=2 * nproc)

    # 4-process runs shorten the stream (4 gloo processes share the
    # machine's cores; the protocol coverage is per-round, not per-chunk)
    C, CHUNK = 2, 512
    N_CHUNKS = 1000 if nproc <= 2 else 400
    h1 = np.asarray(ops.design_lowpass(63, 4000, 44100))
    h2 = h1 * 0.5
    SWITCH = N_CHUNKS // 2  # block index of the retune

    rng = np.random.default_rng(7)  # identical stream on every host
    data = rng.standard_normal((C, CHUNK * N_CHUNKS)).astype(np.float32)
    pos = [0]
    fail_at = [None]

    def feed(n):
        if fail_at[0] is not None and pos[0] >= fail_at[0] * CHUNK:
            raise IOError(f"injected failure on host {pid}")
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0] : pos[0] + n]
        pos[0] += n
        return c

    def src_alloc(ctx, block):
        return Source(output=SignalProperties(44100.0, C), feed=feed)

    fir = parallel.sharded.FIR(h1)
    sink = mock.Sink()
    p = pipe_tpu.Pipe(
        CHUNK,
        pipe_tpu.Line(
            source=src_alloc, processors=[fir.processor()], sink=sink.sink()
        ),
        mesh=mesh,
        host_sync_every=16,
    )

    if mode == "stream":
        # multi-host contract: pushes must be targeted
        p.start()
        # every host pushes the SAME mutation at the SAME stream block —
        # block-indexed delivery makes the landing deterministic across the
        # group (no cross-host control channel needed)
        p.push(fir.set_taps(h2), at_block=SWITCH)
        p.wait(600.0)

        out = sink.values
        assert out.shape == data.shape, out.shape
        x64 = data.astype(np.float64)
        y1 = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
        y2 = scipy.signal.lfilter(h2, [1.0], x64, axis=1)
        s = SWITCH * CHUNK
        oracle = np.concatenate([y1[:, :s], y2[:, s:]], axis=1)
        snr = snr_db(oracle, out)
        assert snr > 100, f"host {pid}: SNR {snr:.1f} dB"
        print(f"stream proc {pid} OK {snr:.1f} dB", flush=True)
        return

    if mode == "stream_untargeted":
        # r4 (VERDICT r3 item 5): UNTARGETED push on a multi-host pipe —
        # reference Push-anywhere semantics (pipe.go:243-247). Both hosts
        # push the same mutation with NO at_block; the frontier+headroom
        # agreement (pending counts exchanged at the aligned health
        # rounds) lands it at the SAME round-aligned chunk on every host.
        # The landing block is timing-dependent but deterministic-across-
        # hosts: each worker detects it from its output and prints it —
        # the parent asserts both hosts detected the SAME block and both
        # clear 100 dB.
        p.start()
        import time as _time

        while p.block_index() < 64:  # mid-stream, past a few rounds
            _time.sleep(0.005)
        # STAGGERED across hosts (r5, 4-process coverage): host pid pushes
        # 0.08*pid seconds later, so the group's pending counts pass
        # through asymmetric states (1,0,0,0) -> ... -> (1,1,1,1); the
        # group-MINIMUM must deliver nothing until every host has pushed,
        # then exactly one batch at the same round frontier everywhere —
        # with two hosts min() and "all agree" were indistinguishable.
        _time.sleep(0.08 * pid)
        p.push(fir.set_taps(h2))  # untargeted
        p.wait(600.0)

        out = sink.values
        assert out.shape == data.shape, out.shape
        x64 = data.astype(np.float64)
        y1 = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
        y2 = scipy.signal.lfilter(h2, [1.0], x64, axis=1)
        best = (-1.0, None)
        for cand in range(16, N_CHUNKS, 16):  # round-aligned candidates
            cs = cand * CHUNK
            oracle = np.concatenate([y1[:, :cs], y2[:, cs:]], axis=1)
            sn = snr_db(oracle, out)
            if sn > best[0]:
                best = (sn, cand)
        snr, landed = best
        assert snr > 100, f"host {pid}: best SNR {snr:.1f} dB"
        print(
            f"stream_untargeted proc {pid} OK {snr:.1f} dB "
            f"landed_at {landed}",
            flush=True,
        )
        return

    if mode == "untargeted_stale":
        # CONTRACT-VIOLATION probe (r5, 4-process coverage): host 0 pushes
        # an untargeted batch its peers never match. The group minimum
        # stays 0, so nothing may ever deliver (a 2-host min() could not
        # distinguish this from agreement); after UNTARGETED_STALE_ROUNDS
        # health rounds host 0 must fail LOUDLY and the flag must abort
        # every peer — the batch must not vanish silently at EOF.
        p.UNTARGETED_STALE_ROUNDS = 4  # fire well before the stream ends
        p.start()
        import time as _time

        while p.block_index() < 32:
            _time.sleep(0.005)
        if pid == 0:
            p.push(fir.set_taps(h2))  # untargeted, never matched by peers
        try:
            p.wait(600.0)
        except Exception as e:  # noqa: BLE001
            msg = str(e).lower()
            if pid == 0:
                assert "without a matching push" in msg, e
            else:
                assert "peer" in msg, e
            print(f"untargeted_stale proc {pid} OK", flush=True)
            return
        raise AssertionError(f"proc {pid}: expected the run to fail")

    if mode == "stream_chunky":
        # r5 short-read re-chunking over REAL processes: both hosts feed
        # the same stream in the same random-length pieces (deterministic
        # seeded lengths — the symmetric-stream contract), the executor
        # re-chunks them into full mesh dispatch chunks, a targeted
        # retune lands on the same sample everywhere, partial EOF tail
        # included.
        N_C = 200
        rngc = np.random.default_rng(77)
        dlen = CHUNK * N_C + 333  # partial final chunk
        dc = rngc.standard_normal((C, dlen)).astype(np.float32)
        qc = [0]
        r_len = np.random.default_rng(78)  # identical on every host

        def feed_c2(n):
            if qc[0] >= dlen:
                return None
            take = min(int(r_len.integers(1, n + 1)), dlen - qc[0])
            c = dc[:, qc[0] : qc[0] + take]
            qc[0] += take
            return c

        fir_c2 = parallel.sharded.FIR(h1)
        sink_c2 = mock.Sink()
        pc2 = pipe_tpu.Pipe(
            CHUNK,
            pipe_tpu.Line(
                source=lambda ctx, b: Source(
                    output=SignalProperties(44100.0, C), feed=feed_c2
                ),
                processors=[fir_c2.processor()],
                sink=sink_c2.sink(),
            ),
            mesh=mesh,
            host_sync_every=16,
        )
        pc2.start()
        SW = N_C // 2
        pc2.push(fir_c2.set_taps(h2), at_block=SW)
        pc2.wait(600.0)

        out = sink_c2.values
        assert out.shape == dc.shape, out.shape
        x64 = dc.astype(np.float64)
        y1 = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
        y2 = scipy.signal.lfilter(h2, [1.0], x64, axis=1)
        s = SW * CHUNK
        oracle = np.concatenate([y1[:, :s], y2[:, s:]], axis=1)
        snr = snr_db(oracle, out)
        assert snr > 100, f"host {pid}: SNR {snr:.1f} dB"
        print(f"stream_chunky proc {pid} OK {snr:.1f} dB", flush=True)
        return

    if mode == "width_insert":
        # r5 width-changing surgery across REAL processes: a 44.1k->48k
        # resampler live-inserted into a running multi-process mesh line
        # at an exact chunk (at_block required by the multi-host
        # contract); every host re-runs its downstream allocators at the
        # new width identically, the sharded FIR halo carries, and the
        # recompiled step starts issuing its (new) collectives at the
        # same chunk everywhere. CHUNK_W=1176 keeps n_local a multiple
        # of 147 at 2 and 4 processes.
        import threading as _threading
        import time as _time

        CHUNK_W, N_W = 1176, 24
        rngw = np.random.default_rng(23)
        dw = rngw.standard_normal((C, CHUNK_W * N_W)).astype(np.float32)
        qw = [0]
        gate = _threading.Event()

        def feed_w(n):
            if qw[0] >= 2 * CHUNK_W:
                gate.wait(120)
            if qw[0] >= dw.shape[1]:
                return None
            c = dw[:, qw[0] : qw[0] + n]
            qw[0] += n
            return c

        fir_w = parallel.sharded.FIR(h1)
        rs_w = parallel.sharded.Resample(48000, 44100)
        sink_w = mock.Sink()
        pw = pipe_tpu.Pipe(
            CHUNK_W,
            pipe_tpu.Line(
                source=lambda ctx, b: Source(
                    output=SignalProperties(44100.0, C), feed=feed_w
                ),
                processors=[fir_w.processor()],
                sink=sink_w.sink(),
            ),
            mesh=mesh,
            host_sync_every=8,
        )
        pw.start()
        AT = 4
        hdl = pw.insert_processor(0, 0, rs_w.processor(), at_block=AT)
        le = pw._exec_of_route[0]
        t0 = _time.time()
        while le._next_target(0) != AT and _time.time() - t0 < 120:
            _time.sleep(0.002)
        gate.set()
        pw.wait(600.0)
        assert hdl.wait(10) and hdl.error is None, hdl.error

        from pipe_tpu.ops.resample import polyphase_design

        cut = AT * CHUNK_W
        L, M = 160, 147
        hp64 = polyphase_design(L, M, 32)
        K = hp64.shape[1]
        tail = dw.astype(np.float64)[:, cut:]
        n_out = -(-tail.shape[1] * L // M)
        jj = np.arange(n_out)
        ph, n0 = (jj * M) % L, (jj * M) // L
        nidx = n0[:, None] - np.arange(K)[None, :]
        valid = (nidx >= 0) & (nidx < tail.shape[1])
        xg = np.where(
            valid[None], tail[:, np.clip(nidx, 0, tail.shape[1] - 1)], 0.0
        )
        res = np.einsum("cok,ok->co", xg, hp64[ph])
        stream_o = np.concatenate(
            [dw.astype(np.float64)[:, :cut], res], axis=1
        )
        oracle = scipy.signal.lfilter(h1, [1.0], stream_o, axis=1)
        assert sink_w.values.shape == oracle.shape, sink_w.values.shape
        snr = snr_db(oracle, sink_w.values)
        assert snr > 100, f"host {pid}: {snr:.1f} dB"
        print(f"width_insert proc {pid} OK {snr:.1f} dB", flush=True)
        return

    if mode == "untargeted_eof":
        # r5 EOF audit: an untargeted batch still awaiting agreement when
        # the stream ENDS (too late for any health round to deliver it,
        # too early for the stale-round budget) must fail loudly on the
        # pushing host, not vanish. Every host pauses its feed briefly at
        # chunk 35 (symmetric pacing) so host 0's push lands inside the
        # final window after the last round (rounds at 16 and 32; EOF at
        # 40).
        import time as _time

        fir_e = parallel.sharded.FIR(h1)
        sink_e = mock.Sink(discard=True)
        short = np.zeros((C, CHUNK * 40), np.float32)
        qpos = [0]

        def feed_e(n):
            if qpos[0] == 35 * CHUNK:
                _time.sleep(0.4)
            if qpos[0] >= short.shape[1]:
                return None
            c = short[:, qpos[0] : qpos[0] + n]
            qpos[0] += n
            return c

        pe = pipe_tpu.Pipe(
            CHUNK,
            pipe_tpu.Line(
                source=lambda ctx, b: Source(
                    output=SignalProperties(44100.0, C), feed=feed_e
                ),
                processors=[fir_e.processor()],
                sink=sink_e.sink(),
            ),
            mesh=mesh,
            host_sync_every=16,
        )
        pe.start()
        if pid == 0:
            while pe.block_index() < 33:
                _time.sleep(0.002)
            pe.push(fir_e.set_taps(h2))  # untargeted, after the last round
        try:
            pe.wait(600.0)
        except Exception as e:  # noqa: BLE001
            msg = str(e).lower()
            if pid == 0:
                assert (
                    "pending at end of stream" in msg
                    or "without a matching push" in msg
                ), e
            else:
                assert "peer" in msg, e
            print(f"untargeted_eof proc {pid} OK", flush=True)
            return
        raise AssertionError(f"proc {pid}: expected the run to fail")

    if mode == "stream_batched":
        # VERDICT r2 item 2: batch_blocks > 1 on a multi-host pipe — one
        # scanned dispatch advances 8 chunks on both hosts in lockstep;
        # the targeted retune splits the batch at the SAME chunk on every
        # host (targets are replicated, late arrival is a loud error), and
        # dispatch batches are also capped at health-round frontiers.
        fir_b = parallel.sharded.FIR(h1)
        sink_b = mock.Sink()
        pb = pipe_tpu.Pipe(
            CHUNK,
            pipe_tpu.Line(
                source=src_alloc, processors=[fir_b.processor()],
                sink=sink_b.sink(),
            ),
            mesh=mesh,
            host_sync_every=16,
            batch_blocks=8,
        )
        pb.start()
        pb.push(fir_b.set_taps(h2), at_block=SWITCH)
        # surgery under batched dispatch: both hosts splice a gain at the
        # same chunk — the recompiled step starts mid-batch everywhere
        SPLICE = 700
        g = parallel.sharded.Gain(0.5)
        hdl = pb.insert_processor(0, 1, g.processor(), at_block=SPLICE)
        pb.wait(600.0)
        assert hdl.wait(10) and hdl.error is None, hdl.error

        out = sink_b.values
        assert out.shape == data.shape, out.shape
        x64 = data.astype(np.float64)
        y1 = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
        y2 = scipy.signal.lfilter(h2, [1.0], x64, axis=1)
        s = SWITCH * CHUNK
        oracle = np.concatenate([y1[:, :s], y2[:, s:]], axis=1)
        oracle[:, SPLICE * CHUNK :] *= np.float64(np.float32(0.5))
        snr = snr_db(oracle, out)
        assert snr > 100, f"host {pid}: SNR {snr:.1f} dB"
        print(f"stream_batched proc {pid} OK {snr:.1f} dB", flush=True)
        return

    if mode == "abort_batched":
        # first-error-wins under batched dispatch: host 1 fails mid-window;
        # its exit padding (single-block no-ops) must complete host 0's
        # in-flight scanned chunks up to the aligned round
        fir_b = parallel.sharded.FIR(h1)
        sink_b = mock.Sink()
        pb = pipe_tpu.Pipe(
            CHUNK,
            pipe_tpu.Line(
                source=src_alloc, processors=[fir_b.processor()],
                sink=sink_b.sink(),
            ),
            mesh=mesh,
            host_sync_every=16,
            batch_blocks=8,
        )
        if pid == 1:
            fail_at[0] = 40
        pb.start()
        try:
            pb.wait(600.0)
        except Exception as e:  # noqa: BLE001
            if pid == 1:
                assert "injected failure" in str(e), e
            else:
                assert "peer" in str(e).lower(), e
            print(f"abort_batched proc {pid} OK", flush=True)
            return
        raise AssertionError(f"proc {pid}: expected the run to fail")

    if mode == "ols_delay":
        # the r3 heavy collectives across a REAL process boundary: the
        # bin-sharded FDL's two all_to_all transposes and the feedback
        # delay's rotated-affine ppermute ladder cross processes every chunk
        N_OD = 200
        P_ir = 300  # > n_local = CHUNK/4 = 128 -> distributed FDL (K=3)
        rng2 = np.random.default_rng(13)
        ir = rng2.standard_normal(P_ir) * np.exp(-np.arange(P_ir) / 60.0)
        d2 = rng2.standard_normal((C, CHUNK * N_OD)).astype(np.float32)
        q2 = [0]

        def feed_od(n):
            if q2[0] >= d2.shape[1]:
                return None
            c = d2[:, q2[0] : q2[0] + n]
            q2[0] += n
            return c

        ols = parallel.sharded.OLS(ir)
        echo = parallel.sharded.Delay(100, feedback=0.4, wet=0.3, dry=1.0)
        # unity-gain STFT stage: exercises the OTHER fft engine (dual-halo
        # analysis/OLA) across the process boundary; with unit gains it is
        # an exact W-hop=48-sample delay
        sg = parallel.sharded.SpectralGain(64, 16)
        sink_od = mock.Sink()
        pod = pipe_tpu.Pipe(
            CHUNK,
            pipe_tpu.Line(
                source=lambda ctx, b: Source(
                    output=SignalProperties(44100.0, C), feed=feed_od
                ),
                processors=[
                    ols.processor(), echo.processor(), sg.processor()
                ],
                sink=sink_od.sink(),
            ),
            mesh=mesh,
            host_sync_every=16,
        )
        pod.start()
        pod.wait(600.0)

        x64 = d2.astype(np.float64)
        conv = scipy.signal.fftconvolve(x64, ir[None, :], axes=1)[
            :, : x64.shape[1]
        ]
        D, fb = 100, 0.4
        a = np.zeros(D + 1)
        a[0], a[D] = 1.0, -fb
        s = scipy.signal.lfilter([1.0], a, conv, axis=1)
        delayed = np.concatenate(
            [np.zeros((C, D)), s[:, :-D]], axis=1
        )
        oracle = 1.0 * conv + 0.3 * delayed
        # the unity STFT stage delays by W-hop = 48 samples
        L = 64 - 16
        oracle = np.concatenate(
            [np.zeros((C, L)), oracle[:, :-L]], axis=1
        )
        snr = snr_db(oracle, sink_od.values)
        assert sink_od.values.shape == d2.shape
        assert snr > 100, f"host {pid}: {snr:.1f} dB"
        print(f"ols_delay proc {pid} OK {snr:.1f} dB", flush=True)
        return

    if mode == "mix_psum":
        # config 5's merged mixer across hosts: channels shard over a mesh
        # axis that spans the PROCESS boundary, so the Mix stage's psum
        # reduction crosses processes every chunk
        mesh_m = parallel.make_global_mesh(
            channel_shards=2, time_shards=nproc
        )
        C_m, N_M = 4, 300
        rng4 = np.random.default_rng(17)
        d4 = rng4.standard_normal((C_m, CHUNK * N_M)).astype(np.float32)
        mixm = rng4.standard_normal((2, C_m)).astype(np.float32)
        q4 = [0]

        def feed_m(n):
            if q4[0] >= d4.shape[1]:
                return None
            c = d4[:, q4[0] : q4[0] + n]
            q4[0] += n
            return c

        fir_m = parallel.sharded.FIR(h1)
        mix = parallel.sharded.Mix(mixm)
        sink_m = mock.Sink()
        pm = pipe_tpu.Pipe(
            CHUNK,
            pipe_tpu.Line(
                source=lambda ctx, b: Source(
                    output=SignalProperties(44100.0, C_m), feed=feed_m
                ),
                processors=[fir_m.processor(), mix.processor()],
                sink=sink_m.sink(),
            ),
            mesh=mesh_m,
            host_sync_every=16,
        )
        pm.start()
        pm.wait(600.0)

        x64 = d4.astype(np.float64)
        fx = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
        oracle = mixm.astype(np.float64) @ fx
        snr = snr_db(oracle, sink_m.values)
        assert sink_m.values.shape == oracle.shape, sink_m.values.shape
        assert snr > 100, f"host {pid}: {snr:.1f} dB"
        print(f"mix_psum proc {pid} OK {snr:.1f} dB", flush=True)
        return

    if mode == "late_target":
        # end-of-stream audit: a target the stream never reaches must fail
        # loudly on every host (deterministic-or-fail), not vanish
        fir_c = parallel.sharded.FIR(h1)
        sink_c = mock.Sink(discard=True)
        short = np.zeros((C, CHUNK * 40), np.float32)
        qpos = [0]

        def feed_c(n):
            if qpos[0] >= short.shape[1]:
                return None
            c = short[:, qpos[0] : qpos[0] + n]
            qpos[0] += n
            return c

        pc = pipe_tpu.Pipe(
            CHUNK,
            pipe_tpu.Line(
                source=lambda ctx, b: Source(
                    output=SignalProperties(44100.0, C), feed=feed_c
                ),
                processors=[fir_c.processor()],
                sink=sink_c.sink(),
            ),
            mesh=mesh,
            host_sync_every=16,
        )
        pc.start()
        pc.push(fir_c.set_taps(h2), at_block=10_000)  # past the stream end
        try:
            pc.wait(600.0)
        except Exception as e:  # noqa: BLE001
            msg = str(e).lower()
            assert "undelivered" in msg or "peer" in msg, e
            print(f"late_target proc {pid} OK", flush=True)
            return
        raise AssertionError(f"proc {pid}: expected the run to fail")

    if mode == "multiline":
        # Two lines in ONE sync group (shared mutable context): the single
        # executor thread issues each line's cross-host collectives in the
        # same order on every process. Mid-stream, both hosts splice a gain
        # into line 0 with at_block-targeted adoption, so the recompiled
        # step starts at the same chunk everywhere.
        from pipe_tpu import mutable as mut

        N2 = 400

        def make_line(seed, taps, mctx, n_chunks=N2):
            r2 = np.random.default_rng(seed)
            d = r2.standard_normal((C, CHUNK * n_chunks)).astype(np.float32)
            q = [0]

            def feed2(n):
                if q[0] >= d.shape[1]:
                    return None
                c = d[:, q[0] : q[0] + n]
                q[0] += n
                return c

            def alloc(ctx, block):
                return Source(output=SignalProperties(44100.0, C), feed=feed2)

            f = parallel.sharded.FIR(taps)
            s = mock.Sink()
            return d, s, pipe_tpu.Line(
                source=alloc, processors=[f.processor()], sink=s.sink(),
                context=mctx,
            )

        mctx = mut.mutable()
        # STAGGERED EOF (r5): line A's stream is half as long — it EOFs,
        # flushes, and splices out of the sync-group sweep mid-run, on the
        # same dispatch on every host, while line B keeps issuing its
        # cross-host collectives to the end
        data_a, sink_a, line_a = make_line(7, h1, mctx, n_chunks=N2 // 2)
        data_b, sink_b, line_b = make_line(8, h2, mctx)
        p2 = pipe_tpu.Pipe(
            CHUNK, line_a, line_b, mesh=mesh, host_sync_every=16
        )
        p2.start()
        SPLICE = 150
        g = parallel.sharded.Gain(0.5)
        h = p2.insert_processor(0, 1, g.processor(), at_block=SPLICE)
        assert h.wait(300) and h.error is None, h.error
        p2.wait(600.0)

        o1 = scipy.signal.lfilter(h1, [1.0], data_a.astype(np.float64), axis=1)
        o1[:, SPLICE * CHUNK :] *= np.float64(np.float32(0.5))
        o2 = scipy.signal.lfilter(h2, [1.0], data_b.astype(np.float64), axis=1)
        s1 = snr_db(o1, sink_a.values)
        s2 = snr_db(o2, sink_b.values)
        assert sink_a.values.shape == data_a.shape
        assert sink_b.values.shape == data_b.shape
        assert s1 > 100 and s2 > 100, (s1, s2)
        print(f"multiline proc {pid} OK {s1:.1f}/{s2:.1f} dB", flush=True)
        return

    if mode == "ckpt":
        # checkpoint/resume across hosts: every process snapshots the
        # sharded state (collective gather of non-addressable leaves —
        # including the 4-D BIN-SHARDED distributed-FDL carry, r3),
        # restores into a fresh mesh pipe, and the resumed stream equals
        # the uninterrupted float64 oracle.
        from pipe_tpu import checkpoint, ops as _ops

        N_CK = 120
        sos = _ops.design_peaking_eq(44100, freq=600, q=1.5, gain_db=3.0)
        rng3 = np.random.default_rng(9)
        P_ck = 300  # > n_local = 128 -> distributed FDL carry in the state
        ir_ck = rng3.standard_normal(P_ck) * np.exp(-np.arange(P_ck) / 60.0)
        d = rng3.standard_normal((C, CHUNK * N_CK)).astype(np.float32)

        def make(part):
            q = [0]

            def feedc(n):
                if q[0] >= part.shape[1]:
                    return None
                c = part[:, q[0] : q[0] + n]
                q[0] += n
                return c

            def alloc(ctx, block):
                return Source(
                    output=SignalProperties(44100.0, C), feed=feedc
                )

            f = parallel.sharded.FIR(h1)
            o = parallel.sharded.OLS(ir_ck)
            b = parallel.sharded.Biquad(sos)
            s = mock.Sink()
            return s, pipe_tpu.Pipe(
                CHUNK,
                pipe_tpu.Line(
                    source=alloc,
                    processors=[f.processor(), o.processor(), b.processor()],
                    sink=s.sink(),
                ),
                mesh=mesh,
                host_sync_every=16,
            )

        half = CHUNK * (N_CK // 2)
        sink_a, pa = make(d[:, :half])
        pa.start()
        pa.wait(600.0)
        ck = checkpoint.snapshot(pa)  # collective across processes

        sink_b, pb = make(d[:, half:])
        checkpoint.restore(pb, ck)
        pb.start()
        pb.wait(600.0)

        out = np.concatenate([sink_a.values, sink_b.values], axis=1)
        x64 = d.astype(np.float64)
        fx = scipy.signal.lfilter(h1, [1.0], x64, axis=1)
        cx = scipy.signal.fftconvolve(fx, ir_ck[None, :], axes=1)[
            :, : x64.shape[1]
        ]
        oracle = scipy.signal.sosfilt(sos[None, :], cx, axis=1)
        snr = snr_db(oracle, out)
        assert out.shape == d.shape, out.shape
        assert snr > 100, f"host {pid}: {snr:.1f} dB"
        print(f"ckpt proc {pid} OK {snr:.1f} dB", flush=True)
        return

    if mode in ("abort", "abort_late"):
        # host 1 fails; host 0 must abort via the health round. "abort"
        # fails mid-stream; "abort_late" fails INSIDE the last health
        # window (after host 0's stream already ended) — host 0's EOF
        # final round is what keeps host 1's padded collectives and flag
        # from hanging with no counterpart.
        if mode == "abort_late":
            short = 100 * CHUNK
            data_view = data[:, :short]

            def feed_short(n, _d=data_view):
                if fail_at[0] is not None and pos[0] >= fail_at[0] * CHUNK:
                    raise IOError(f"injected failure on host {pid}")
                if pos[0] >= _d.shape[1]:
                    return None
                c = _d[:, pos[0] : pos[0] + n]
                pos[0] += n
                return c

            src_alloc2 = lambda ctx, block: Source(  # noqa: E731
                output=SignalProperties(44100.0, C), feed=feed_short
            )
            fir2 = parallel.sharded.FIR(h1)
            sink2 = mock.Sink()
            p = pipe_tpu.Pipe(
                CHUNK,
                pipe_tpu.Line(
                    source=src_alloc2, processors=[fir2.processor()],
                    sink=sink2.sink(),
                ),
                mesh=mesh,
                host_sync_every=16,
            )
            if pid == 1:
                fail_at[0] = 98  # within the final 16-dispatch window
        elif pid == 1:
            fail_at[0] = 40
        p.start()
        try:
            p.wait(600.0)
        except Exception as e:  # noqa: BLE001
            kind = type(e).__name__
            cause = type(e.__cause__).__name__ if e.__cause__ else ""
            print(f"{mode} proc {pid} raised {kind}/{cause}: {e}", flush=True)
            if pid == 1:
                assert "injected failure" in str(e), e
            else:
                assert "peer" in str(e).lower(), e
            print(f"{mode} proc {pid} OK", flush=True)
            return
        raise AssertionError(f"proc {pid}: expected the run to fail")

    raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
