"""Measured auto-policy for multiblock-rejection-recycling (MR) serving.

A faithful copy of `jacobiforcing_tpu/engine/mr_policy.py` (the code below the
docstring is the original's, line for line, so a differential test can hold
the two to the same picks, locks and snapshots).

Why a policy at all: the reference ships MR with GPU-tuned defaults (K=2
blocks, n-gram pool 4) on the view that extra speculative rows ride free
through under-used SMs.  The JAX package found the opposite on its TPU (the
full candidate tier cost far more wall per iteration than it returned in
tokens per forward), and since whether candidates pay depends on the
WORKLOAD (pool hit rate, acceptance structure) it measures online instead of
hard-coding a default.  Those TPU measurements were that package's reason for
the policy; nothing here states a time for this port, whose per-tier times
are in PERF.md.

Four arms.  The first three run the SAME MR chunk program over the SAME
carried state (greedy MR == greedy AR token for token), so switches among
them are invisible in the output stream and only throughput changes:

  * mr_full    - MR as requested (candidates + pseudo blocks);
  * mr_nocand  - the n-gram candidate tier disabled by raising
                 `lookahead_start` past N (block acceptance can never reach
                 it, so no candidate is ever valid and the chunk program
                 takes its no-candidate forward);
  * mr_ra_only - additionally stops pseudo spawning (spawn threshold N+1),
                 draining the state machine to its RA-only tier: an N-token
                 forward per iteration with MR state continuity.  Still not
                 single-block acceptance: the draft SHRINKS toward each block
                 end and every fresh block restarts from a cold [next | PAD..]
                 draft;
  * single     - the TRUE single-block program (`runner.jacobi_chunk_greedy`,
                 a sliding L-token window with no block boundaries).  The
                 engine hands MR state off exactly: MR -> single at any chunk
                 boundary (single's draft[0] is the last committed token and
                 its verifier never pre-commits, so any speculative tail is
                 safe; the RA draft seeds it); single -> MR re-verifies the
                 continuation with one non-committing AR forward, because MR
                 pre-commits RA draft[0] unconditionally.

Policy: interleaved probe windows (round-robin over arms, `probe_chunks`
counted calls each), then lock to the highest measured committed-token rate;
re-probe every `reprobe_every` calls, and immediately when the locked arm's
recent rate collapses below `drift_ratio` of its lock-time rate.  Each
reprobe that re-confirms the same winner doubles the next reprobe interval
(capped at `backoff_cap`x); a winner change or a drift unlock resets it.
Reprobe decisions use PROBE-WINDOW-ONLY rates: at each unlock the per-arm
accumulators are reset and the pre-unlock rates are kept only as tiebreakers.
`discard_first=True` (the engine's setting) drops each arm's FIRST-EVER
sample, which may carry one-time set-up cost (here: the first build and load
of a CUDA kernel).  Rates are normalized PER BATCH SLOT (tokens / (slots x
wall)); arm-transition costs (the single -> MR re-entry forward) are kept out
of the timed window.  Wall time is measured around the chunk INCLUDING its
host readback.
"""

from __future__ import annotations

from typing import List, Optional

ARMS = ("mr_full", "mr_nocand", "mr_ra_only", "single")
ARM_SINGLE = 3


class MRAutoPolicy:
    """Per-(L, K, C) group online arm selection for MR serving."""

    def __init__(self, probe_chunks: int = 4, reprobe_every: int = 256,
                 drift_ratio: float = 0.6, backoff_cap: int = 16,
                 n_arms: int = 3, discard_first: bool = False):
        assert probe_chunks >= 1 and reprobe_every > n_arms * probe_chunks
        assert 1 <= n_arms <= len(ARMS)
        self.probe_chunks = probe_chunks
        self.reprobe_every = reprobe_every
        self.drift_ratio = drift_ratio
        self.backoff_cap = backoff_cap
        self.n_arms = n_arms
        self.discard_first = discard_first
        self.slot_wall: List[float] = [0.0] * n_arms  # sum(slots * wall_s)
        self.tokens: List[int] = [0] * n_arms
        self.n: List[int] = [0] * n_arms  # samples in the CURRENT window
        self.seen: List[int] = [0] * n_arms  # lifetime samples (discard_first)
        self.prior: List[float] = [0.0] * n_arms  # last-window rates (tiebreak)
        self.calls = 0
        self.locked: Optional[int] = None  # arm index, None while probing
        # samples per arm needed to close the CURRENT probe window: scheduled
        # reprobes use the full probe_chunks; a DRIFT unlock re-ranks with 1
        # fresh chunk per arm (priors break ties).  Round-5 finding: the
        # drift detector fires on continuous-batching drain phases (per-slot
        # yields collapse for every arm as requests finish mid-chunk), and a
        # full-breadth reprobe each time burned ~40% of a B=8 serving run on
        # the expensive MR arms (engine row: 503 MR probe iterations vs 434
        # serving ones).  The phase change is real — rates did move — so
        # reprobing is correct; only its breadth was wrong.
        self._probe_target = probe_chunks
        self._since_lock = 0
        self._lock_rate = 0.0  # per-slot rate at lock time
        self._ema_rate: Optional[float] = None  # recent locked-arm rate
        self._interval = reprobe_every  # current reprobe interval (backoff)
        self._stable = 0  # consecutive reprobes confirming the same winner
        self._last_winner: Optional[int] = None

    # ------------------------------------------------------------------
    def _rate(self, a: int) -> float:
        return self.tokens[a] / self.slot_wall[a] if self.slot_wall[a] > 0 else 0.0

    def _unlock(self, drift: bool = False) -> None:
        # probe-window-only decisions: reset the accumulators so the winner
        # is chosen from fresh samples; keep the old rates as tiebreakers
        self.locked = None
        for a in range(self.n_arms):
            if self.slot_wall[a] > 0:
                self.prior[a] = self._rate(a)
        self.slot_wall = [0.0] * self.n_arms
        self.tokens = [0] * self.n_arms
        self.n = [0] * self.n_arms
        self._ema_rate = None
        self._probe_target = 1 if drift else self.probe_chunks
        if drift:
            # the workload changed under us: stability evidence is stale
            self._stable = 0
            self._interval = self.reprobe_every
            self._last_winner = None

    def pick(self) -> int:
        """Arm for the next chunk call."""
        if self.locked is not None:
            if self._since_lock >= self._interval:
                self._unlock()
            else:
                return self.locked
        # interleave: the arm with the fewest probe samples goes next, so
        # arms see the same workload mix even as the batch drains
        return min(range(self.n_arms), key=lambda a: (self.n[a], a))

    def record(self, arm: int, tokens: int, wall_s: float,
               slots: int = 1, drained: bool = False) -> None:
        """Account one chunk call: `tokens` committed over `wall_s` seconds
        by a batch of `slots` sequences (rates are per slot-second).

        `drained=True` marks a chunk during which some row hit its finish
        condition: its per-slot yield collapses for STRUCTURAL reasons (the
        batch is draining), so it must not feed the drift detector — the
        round-5 engine row showed drain edges opening a probe window at the
        tail of every batch, burning 25-50% of short-generation serving on
        probes.  Probe windows still ingest drained chunks (the round-robin
        interleave shows every arm the same workload mix)."""
        self.calls += 1
        first = self.seen[arm] == 0
        self.seen[arm] += 1
        if self.discard_first and first:
            # likely contains this arm's one-time XLA compile wall
            return
        slots = max(int(slots), 1)
        rate = tokens / max(wall_s * slots, 1e-9)
        if self.locked is not None:
            self._since_lock += 1
            if arm == self.locked and not drained:
                self._ema_rate = (
                    rate if self._ema_rate is None
                    else 0.7 * self._ema_rate + 0.3 * rate
                )
                if (
                    self._since_lock >= 3
                    and self._ema_rate < self.drift_ratio * self._lock_rate
                ):
                    # workload drifted under the locked arm
                    self._unlock(drift=True)
            return
        self.tokens[arm] += int(tokens)
        self.slot_wall[arm] += float(wall_s) * slots
        self.n[arm] += 1
        if min(self.n) >= self._probe_target:
            best = max(
                range(self.n_arms), key=lambda a: (self._rate(a), self.prior[a])
            )
            # switch hysteresis: dethroning the incumbent requires beating it
            # by a margin — with near-tie arms (e.g. the ra_only/single pair
            # on some checkpoints) small probe windows re-rank on noise and
            # the lock would random-walk across arms every reprobe
            inc = self._last_winner
            if (
                inc is not None and best != inc and self.n[inc] > 0
                and self._rate(best) < 1.1 * self._rate(inc)
            ):
                best = inc
            self.locked = best
            self._since_lock = 0
            self._lock_rate = self._rate(self.locked)
            self._ema_rate = None
            # reprobe backoff: a re-confirmed winner doubles the next
            # interval (stable workload -> probe overhead decays); a new
            # winner resets it
            if self._last_winner == self.locked:
                self._stable += 1
            else:
                self._stable = 0
            self._interval = self.reprobe_every * min(
                1 << self._stable, self.backoff_cap
            )
            self._last_winner = self.locked

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "locked": ARMS[self.locked] if self.locked is not None else None,
            "calls": self.calls,
            "tokens_per_slot_s": [
                round(self._rate(a), 2) for a in range(self.n_arms)
            ],
            "n": list(self.n),
            "reprobe_interval": self._interval,
        }
