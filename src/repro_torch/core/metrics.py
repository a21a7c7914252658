"""Round-by-round measurement of the paper's phenomena (the port's
``repro.core.metrics.RoundLog``; numpy only).

The paper's central instrument is test accuracy evaluated at *both* phase
boundaries of every round (after local training, after consensus).  The
port's log also keeps each round's wall seconds.
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
