"""Per-section codec-selection ("method learning") state machine.

Mirrors metrics_method / metrics_update / compress_with_methods
(fqzcomp5.c:1899-2144): for the first METRICS_TRIAL blocks every allowed
method is tried and accumulated; then the best compressed/uncompressed
ratio is locked in; every METRICS_REVIEW blocks the trial re-opens.

Thread-safe: a single lock guards the shared tables, like the
reference's metric_m mutex.
"""

from __future__ import annotations

import threading

from fqzcomp5_tpu_torch.constants import M_LAST, METRICS_REVIEW, METRICS_TRIAL, SEC_LAST


class MethodLearner:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._usize = [[0] * M_LAST for _ in range(SEC_LAST)]
        self._csize = [[0] * M_LAST for _ in range(SEC_LAST)]
        self._review = [0] * SEC_LAST
        self._trial = [0] * SEC_LAST
        self._used = [0] * SEC_LAST
        self.method_avail = [0] * SEC_LAST

    def methods_for(self, sec: int) -> int:
        """Bitmask of methods to try for the next block of `sec`."""
        with self._lock:
            if self._review[sec] <= 0:
                self._review[sec] = METRICS_REVIEW
                self._trial[sec] = METRICS_TRIAL
                self._usize[sec] = [0] * M_LAST
                self._csize[sec] = [0] * M_LAST

            if self._trial[sec] > 0:
                return self.method_avail[sec]
            if self._trial[sec] > -99999:
                best_m = 0
                best_ratio = 1e30
                for m in range(M_LAST):
                    if self._usize[sec][m]:
                        r = (self._csize[sec][m] + 1.0) / self._usize[sec][m]
                        if best_ratio > r:
                            best_ratio = r
                            best_m = m
                self._used[sec] = best_m
                self._trial[sec] = -99999
                return 1 << best_m
            self._review[sec] -= 1
            return 1 << self._used[sec]

    def in_trial(self, sec: int) -> bool:
        with self._lock:
            return self._trial[sec] > 0

    def trial_remaining(self, sec: int) -> int:
        """Trial blocks still outstanding (0 when locked).  Lets the
        wave driver size a trial segment without peeking mid-batch."""
        with self._lock:
            return max(self._trial[sec], 0)

    def review_remaining(self, sec: int) -> int:
        """Locked blocks left before the review re-opens the trial
        (lets the distributed wave engine decide — identically on
        every process — whether a wave can contain trial activity)."""
        with self._lock:
            return self._review[sec]

    def will_reopen(self, sec: int) -> bool:
        """True when the NEXT methods_for call re-opens the trial
        (review counter exhausted) — a wave segment boundary."""
        with self._lock:
            return self._review[sec] <= 0

    def record_trial(self, sec: int, sizes: dict[int, tuple[int, int]]) -> None:
        """Accumulate per-method (usize, csize) of one trial block."""
        with self._lock:
            if self._trial[sec] <= 0:
                return
            for m, (u, c) in sizes.items():
                self._usize[sec][m] += u
                self._csize[sec][m] += c
            self._trial[sec] -= 1
            if self._journal is not None:
                self._journal.append((sec, dict(sizes)))

    # -- trial journal: lets a distributed owner ship one block's trial
    # stats to its peers so every learner evolves in lock-step without
    # redundant codec work (parallel/distributed.py) -----------------
    _journal: list | None = None

    def start_journal(self) -> None:
        self._journal = []

    def pop_journal(self) -> list:
        j, self._journal = self._journal or [], None
        return j

    def replay_journal(self, journal) -> None:
        """Apply a peer's trial stats (after calling methods_for for
        the block exactly as the owner did)."""
        for sec, sizes in journal:
            self.record_trial(sec, sizes)


def journal_dumps(journal) -> bytes:
    """Wire-encode a trial journal as JSON.

    The journal crosses process boundaries on the distributed mesh
    (parallel/distributed.py, parallel/dist_tpu.py).  It used to ride
    as pickle — a remote-code-execution surface: any peer (or anything
    that can write to the all-gather) could inject an arbitrary
    object graph.  JSON carries exactly the ints the journal contains
    and nothing else executes on load."""
    import json

    return json.dumps(
        [[int(sec), {str(m): [int(u), int(c)]
                     for m, (u, c) in sizes.items()}]
         for sec, sizes in journal]).encode()


def journal_loads(blob: bytes):
    """Decode journal_dumps output.  Raises ValueError on anything
    malformed (fuzzed in tests/test_fuzz_deep.py) — never executes
    payload content."""
    import json

    try:
        raw = json.loads(blob.decode())
        if not isinstance(raw, list):
            raise ValueError("journal must be a JSON list")
        out = []
        for sec, sizes in raw:
            out.append((int(sec),
                        {int(m): (int(u), int(c))
                         for m, (u, c) in sizes.items()}))
        return out
    except (UnicodeDecodeError, json.JSONDecodeError, TypeError,
            KeyError, AttributeError) as e:
        raise ValueError(f"malformed trial journal: {e}") from e
