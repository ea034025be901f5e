"""Adaptive speculation depth for the serving engine's spec mode; the
port's own copy of ``kubeml_tpu/serving/spec.py`` (plain Python).

A spec step costs k drafter forwards plus one (k+1)-wide verify forward
and emits ``1 + acceptance * k`` tokens in expectation, so k should shrink
while the drafter is usually wrong and grow back while it is usually
right. :class:`AdaptiveK` tracks the per-step acceptance ratio as an EWMA
and walks k up and down a power-of-two ladder capped at ``k_max``, with a
cooldown between moves. When even k = 1 loses, the self-drafting backend
suspends speculation (``current() == 0``: plain decode chunks) and
re-probes at k = 1 after ``probe_every`` plain chunks.

The draft-model backend never suspends (``allow_off=False``): its own KV
arena is coherent only while the drafter sees every decoded token, so k
floors at 1. Its retreat is ``min_accept``: a sustained EWMA below that
floor, once ``cooldown`` samples have settled it, disables drafting for
good (a mismatched draft model does not get better).
"""

from __future__ import annotations

from typing import List


class AdaptiveK:
    """EWMA acceptance tracker + pow2 k-ladder walker.

    ``on_step(drafted, accepted)`` after every spec step;
    ``on_plain_chunk()`` after every plain chunk while suspended;
    ``current()`` is the k of the next spec step (0 = suspended or
    disabled: run a plain chunk instead).
    """

    # below LOW k halves (k = 1 suspends where allowed), above HIGH it
    # doubles toward the cap; the gap is the hysteresis band. A
    # self-drafting step at exit depth e of D costs ~k * e/D + 1 target
    # forwards for 1 + a*k tokens: with e/D ~ 1/2 the break-even
    # acceptance is ~1/2.
    LOW = 0.35
    HIGH = 0.80

    def __init__(self, k_max: int, *, adaptive: bool = True,
                 allow_off: bool = True, low: float = LOW,
                 high: float = HIGH, ewma: float = 0.2,
                 cooldown: int = 8, probe_every: int = 64,
                 min_accept: float = 0.0):
        if k_max < 1:
            raise ValueError("k_max must be >= 1")
        if not (0.0 <= min_accept < 1.0):
            raise ValueError("min_accept must be in [0, 1)")
        ladder = []
        t = 1
        while t < k_max:
            ladder.append(t)
            t *= 2
        ladder.append(int(k_max))
        self.ladder: List[int] = ladder  # ascending, ends at k_max
        self.adaptive = bool(adaptive)
        self.allow_off = bool(allow_off)
        self.low = float(low)
        self.high = float(high)
        self.alpha = float(ewma)
        self.cooldown = int(cooldown)
        self.probe_every = int(probe_every)
        self.min_accept = float(min_accept)
        self._idx = len(ladder) - 1  # start at the configured cap
        self._suspended = False
        self._ratio: float = -1.0    # EWMA; < 0 = no sample yet
        self._since_move = 0
        self._steps_seen = 0
        self._plain_chunks = 0
        self.moves = 0
        self.suspensions = 0
        # the min_accept floor tripped: never re-arms
        self.disabled = False

    def current(self) -> int:
        """The k of the next spec step; 0 = suspended or disabled."""
        if self.disabled:
            return 0
        return 0 if self._suspended else self.ladder[self._idx]

    @property
    def ratio(self) -> float:
        """The EWMA acceptance ratio (-1 before the first sample)."""
        return self._ratio

    def on_step(self, drafted: int, accepted: int) -> None:
        """Feed one spec step's drafted and accepted token counts."""
        if drafted <= 0:
            return
        r = accepted / drafted
        self._ratio = (r if self._ratio < 0
                       else self.alpha * r + (1 - self.alpha) * self._ratio)
        self._steps_seen += 1
        # the floor guards a broken configuration, so it fires whether or
        # not k adapts, once a cooldown's worth of samples settled the EWMA
        if (self.min_accept > 0.0 and not self.disabled
                and self._steps_seen >= self.cooldown
                and self._ratio < self.min_accept):
            self.disabled = True
            return
        if not self.adaptive:
            return
        self._since_move += 1
        if self._since_move < self.cooldown:
            return
        if self._ratio < self.low:
            if self._idx > 0:
                self._idx -= 1
                self.moves += 1
            elif self.allow_off and not self._suspended:
                self._suspended = True
                self._plain_chunks = 0
                self.suspensions += 1
            self._since_move = 0
        elif self._ratio > self.high and self._idx < len(self.ladder) - 1:
            self._idx += 1
            self.moves += 1
            self._since_move = 0

    def on_plain_chunk(self) -> None:
        """While suspended, count plain chunks toward the re-probe."""
        if not self._suspended:
            return
        self._plain_chunks += 1
        if self._plain_chunks >= self.probe_every:
            # probe at the bottom rung with a fresh estimate: the EWMA that
            # suspended speculation must not suspend it again at once
            self._suspended = False
            self._idx = 0
            self._ratio = -1.0
            self._since_move = 0
