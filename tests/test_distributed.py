"""Multi-process (multi-"host") execution over a real jax.distributed
process group — the multi-process layer tested with actual separate processes, not
just virtual devices (SURVEY.md §2 parallelism table: cross-host = a process group via
jax.distributed.initialize + collectives over the global mesh)."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_group_sharded_chain():
    worker = os.path.join(os.path.dirname(__file__), "dcn_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", coord],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out


def _run_workers(worker_name: str, args, timeout=300, n_procs=2):
    worker = os.path.join(os.path.dirname(__file__), worker_name)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, *args, str(pid), str(n_procs), coord],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in range(n_procs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return procs, outs


def test_two_host_streaming_pipe_1000_chunks():
    """VERDICT r1 item 5: two real processes stream 1000 chunks through a
    mesh Pipe with the FIR halo crossing the process boundary every chunk,
    plus a block-indexed mutation landing on the same sample on both hosts.
    Output parity vs the float64 oracle asserted on BOTH hosts."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["stream"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"stream proc {pid} OK" in out


def test_two_host_untargeted_push_agreement():
    """r4 (VERDICT r3 item 5): an UNTARGETED push on a multi-host pipe —
    reference Push-anywhere semantics — lands at the SAME round-aligned
    chunk on every host via the frontier+headroom agreement piggybacked
    on the health rounds, with >100 dB on both hosts."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["stream_untargeted"])
    landed = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"stream_untargeted proc {pid} OK" in out
        landed.append(out.split("landed_at ")[1].split()[0])
    assert landed[0] == landed[1], f"hosts landed at different chunks: {landed}"


def test_two_host_streaming_pipe_batched_dispatch():
    """VERDICT r2 item 2: batch_blocks=8 on a multi-host pipe — 1000
    chunks, one scanned dispatch per 8 chunks, a targeted retune AND
    targeted surgery (insert_processor) splitting batches at the same
    chunks on both hosts, SNR > 100 dB on both."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["stream_batched"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"stream_batched proc {pid} OK" in out


def test_two_host_batched_dispatch_abort():
    """First-error-wins across hosts under batched dispatch: the exit
    padding must complete the healthy host's in-flight scanned chunks."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["abort_batched"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"abort_batched proc {pid} OK" in out


def test_two_host_distributed_fdl_and_delay_ladder():
    """The r3 heavy collectives across a REAL process boundary: the
    bin-sharded OLS FDL's all_to_all transposes and the feedback delay's
    ppermute ladder cross processes every chunk; both hosts match the float64
    oracle at > 100 dB."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["ols_delay"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"ols_delay proc {pid} OK" in out


def test_two_host_merged_mixer_psum():
    """Config 5's merged mixer across hosts: the channel axis spans the
    process boundary, so the Mix stage's psum reduction crosses processes every
    chunk; both hosts' (replicated) mixed outputs match the float64
    oracle at > 100 dB."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["mix_psum"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"mix_psum proc {pid} OK" in out


def test_two_host_undelivered_target_fails_loudly():
    """A targeted mutation the stream never reaches must abort every host
    (deterministic-or-fail), not silently vanish on whichever host raced
    the EOF."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["late_target"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"late_target proc {pid} OK" in out


def test_two_host_first_error_wins_abort():
    """A component failure on one host aborts the whole process group via
    the aligned health rounds (first-error-wins across hosts); the healthy
    host raises PeerAbortError instead of hanging in a collective."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["abort"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"abort proc {pid} OK" in out


def test_two_host_multiline_pipe_with_targeted_surgery():
    """Two lines in ONE sync group streaming over a 2-process mesh, plus
    insert_processor(at_block=) called identically on both hosts: the
    recompiled step starts at the same chunk everywhere (collective
    alignment), and both sinks match their float64 oracles."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["multiline"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"multiline proc {pid} OK" in out


def test_two_host_short_read_rechunking():
    """r5 short-read re-chunking under the multi-host symmetric-stream
    contract: both hosts feed random-length pieces (identical seeded
    lengths), the executor re-chunks them into aligned mesh dispatch
    chunks, a targeted retune lands on the same sample everywhere,
    partial EOF tail included; >100 dB on both hosts."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["stream_chunky"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"stream_chunky proc {pid} OK" in out


def test_two_host_width_changing_insert():
    """r5 width-changing surgery across REAL processes: a resampler
    live-inserted at an exact chunk into a 2-process mesh line; the
    downstream rebuild runs identically on both hosts, the sharded FIR
    halo carries, >100 dB on both."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["width_insert"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"width_insert proc {pid} OK" in out


def test_four_host_width_changing_insert():
    """The same width-changing surgery at FOUR processes (1x8 time axis,
    n_local=147): the re-allocation and the recompiled collective
    sequence stay aligned across all four hosts."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["width_insert"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"width_insert proc {pid} OK" in out


def test_two_host_checkpoint_resume():
    """Checkpoint/resume across a 2-process mesh: snapshot gathers the
    sharded state collectively, restore into a fresh mesh pipe, resumed
    output equals the uninterrupted float64 oracle on both hosts."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["ckpt"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"ckpt proc {pid} OK" in out


def test_two_host_abort_in_final_window():
    """A host failure INSIDE the last health window — after the peer's
    stream already EOF'd — must still abort cleanly: the peer's EOF final
    round completes the failing host's padded collectives and delivers its
    flag (no counterpart -> hang, the bug this pins)."""
    procs, outs = _run_workers("dcn_stream_worker.py", ["abort_late"])
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"abort_late proc {pid} OK" in out


# -- 4-process group (r5, VERDICT r4 item 4): the corners a 2-process
# -- group cannot reach — group-minimum vs all-agree, multiple survivors,
# -- staggered line EOF in a bigger sweep ---------------------------------


def test_four_host_stream_time_axis_spans_processes():
    """A 1x8 time-sharded chunk stream across FOUR real processes: the FIR
    halo crosses three process boundaries every chunk, a targeted
    retune lands on the same sample everywhere, >= 100 dB on every host."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["stream"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"stream proc {pid} OK" in out


def test_four_host_untargeted_push_agreement_staggered():
    """Untargeted pushes STAGGERED across four hosts: the pending counts
    pass through asymmetric states (1,0,0,0 ... 1,1,1,1); the
    group-minimum agreement must deliver nothing until all four hosts
    have pushed, then land the batch at the SAME round-aligned chunk on
    every host. With two processes min() and 'all agree' were
    indistinguishable — this is the corner that tells them apart."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["stream_untargeted"], timeout=600, n_procs=4
    )
    landed = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"stream_untargeted proc {pid} OK" in out
        landed.append(out.split("landed_at ")[1].split()[0])
    assert len(set(landed)) == 1, f"hosts landed at different chunks: {landed}"


def test_four_host_unmatched_untargeted_push_fails_loudly():
    """One host pushes an untargeted batch its three peers never match:
    the group minimum stays 0 forever, so nothing may deliver, and after
    the stale-round budget the pushing host fails LOUDLY ('without a
    matching push') and its flag aborts all three peers — the batch must
    not vanish silently."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["untargeted_stale"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"untargeted_stale proc {pid} OK" in out


def test_four_host_untargeted_pending_at_eof_fails_loudly():
    """An untargeted batch pushed after the LAST health round — no round
    left to deliver it, stream too short for the stale budget — must trip
    the r5 end-of-stream audit on the pushing host (its peers abort via
    the flag), never vanish silently."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["untargeted_eof"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"untargeted_eof proc {pid} OK" in out


def test_four_host_abort_three_survivors():
    """First-error-wins with THREE survivors: host 1 fails mid-stream; its
    exit padding must complete the in-flight chunks of all three healthy
    hosts (each raises PeerAbortError instead of hanging in a half-issued
    collective)."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["abort"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"abort proc {pid} OK" in out


def test_four_host_heavy_collectives_ols_delay_stft():
    """The heavy collective set over a FOUR-process group: the bin-sharded
    distributed-FDL OLS's two all_to_all transposes, the feedback delay
    ladder, and the dual-halo STFT all cross three process edges every chunk;
    every host matches the float64 oracle > 100 dB."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["ols_delay"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"ols_delay proc {pid} OK" in out


def test_four_host_checkpoint_resume():
    """Checkpoint/resume across a 4-process mesh: the snapshot's
    collective gather of non-addressable leaves (including the 4-D
    bin-sharded FDL carry) spans four processes; resumed output equals
    the uninterrupted oracle on every host."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["ckpt"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"ckpt proc {pid} OK" in out


def test_four_host_multiline_staggered_eof_with_surgery():
    """Two lines in ONE sync group over a 4-process mesh: line A EOFs and
    splices out of the sweep at half-stream (same dispatch on every host)
    while line B runs on; targeted surgery lands identically everywhere;
    both sinks match their float64 oracles on all four hosts."""
    procs, outs = _run_workers(
        "dcn_stream_worker.py", ["multiline"], timeout=600, n_procs=4
    )
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"multiline proc {pid} OK" in out
