"""Round-by-round measurement of the paper's phenomena (the port's
``repro.core.metrics.RoundLog``; numpy only).

The paper's central instrument is test accuracy evaluated at *both* phase
boundaries of every round (after local training, after consensus).  The
port's log also keeps each eval period's wall seconds per round, the
scan driver's capture time and, for a sharded run (one process per peer),
each rank's exchange statistics and kernel launches.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class RoundLog:
    """Accumulates per-round measurements; numpy-only."""

    after_local: dict[str, list] = dataclasses.field(default_factory=dict)
    after_consensus: dict[str, list] = dataclasses.field(default_factory=dict)
    drift: list = dataclasses.field(default_factory=list)
    consensus_error: list = dataclasses.field(default_factory=list)
    train_loss: list = dataclasses.field(default_factory=list)
    seconds: list = dataclasses.field(default_factory=list)  # wall time per round
    # the scan driver's warm-up round and capture (in the first period's seconds too)
    capture_seconds: float = 0.0
    # a sharded run's ranks: {"exchange": PeerGroup.stats, "launches": {kernel: n}} each
    ranks: list = dataclasses.field(default_factory=list)

    def record(
        self,
        *,
        local_acc: dict[str, Any],
        consensus_acc: dict[str, Any],
        drift: float,
        consensus_error: float,
        train_loss: float,
        seconds: float,
    ) -> None:
        """Append one round's per-group accuracies and scalars."""
        for k, v in local_acc.items():
            self.after_local.setdefault(k, []).append(np.asarray(v, np.float64))
        for k, v in consensus_acc.items():
            self.after_consensus.setdefault(k, []).append(np.asarray(v, np.float64))
        self.drift.append(float(drift))
        self.consensus_error.append(float(consensus_error))
        self.train_loss.append(float(train_loss))
        self.seconds.append(float(seconds))

    def series(self, group: str, phase: str = "consensus") -> np.ndarray:
        """(rounds, ...) stacked accuracy series for a group and phase."""
        src = self.after_consensus if phase == "consensus" else self.after_local
        return np.stack(src[group])

    def oscillation(self, group: str) -> np.ndarray:
        """Per-round |after_consensus - after_local|, averaged over peers."""
        a = np.stack(self.after_local[group])
        c = np.stack(self.after_consensus[group])
        d = np.abs(c - a)
        return d.mean(axis=tuple(range(1, d.ndim))) if d.ndim > 1 else d

    def final_accuracy(self, group: str, phase: str = "consensus", last_n: int = 5) -> float:
        """Mean accuracy over the last ``last_n`` rounds (peer-averaged)."""
        s = self.series(group, phase)
        s = s.mean(axis=tuple(range(1, s.ndim))) if s.ndim > 1 else s
        return float(s[-last_n:].mean())
