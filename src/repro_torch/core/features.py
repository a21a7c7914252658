"""The feature-compatibility table (the port's ``repro.core.features``).

Every pairwise "feature A does not compose with feature B" rejection lives
here and raises one formatted message, the reference's word for word, from
whichever layer catches the combination.  Every pair of the reference's
table is ported, in its order: staleness x adaptive partner selection,
staleness x compression, adaptive selection x the (one-slice) hierarchical
runtime, compression x the hierarchical runtime, async rounds x the
hierarchical runtime, and a registry task (``model != "mnist_mlp"``) x the
hierarchical runtime.  The reference's table has no push-sum row: push-sum
composes with a compressed wire, with async rounds, with adaptive selection
and with the hierarchical runtime, as in the reference.
``support_matrix_markdown`` renders the table as the README's support
matrix, the reference's string (``tools/check_support_matrix.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class FeatureContext:
    """Plain-value snapshot of one run's feature axes."""

    schedule: str = "static"
    compressor: str = "none"
    steps_profile: str = "uniform"
    staleness_bound: int = 0
    model: str = "mnist_mlp"
    peers_per_device: int = 1  # a runtime axis a frozen config cannot know


def context_from_config(cfg, *, peers_per_device: int = 1) -> FeatureContext:
    """Snapshot a ``P2PConfig``(-shaped) object into a ``FeatureContext``."""
    return FeatureContext(schedule=cfg.schedule, compressor=cfg.compressor,
                          steps_profile=cfg.steps_profile,
                          staleness_bound=cfg.staleness_bound,
                          model=getattr(cfg, "model", "mnist_mlp"),
                          peers_per_device=peers_per_device)


@dataclasses.dataclass(frozen=True)
class Feature:
    """One composable axis: when is it on, and how is it named in errors."""

    name: str
    title: str  # static label for the generated support matrix
    predicate: Callable[[FeatureContext], bool]
    describe: Callable[[FeatureContext], str]


@dataclasses.dataclass(frozen=True)
class Incompatibility:
    """An (a, b) feature pair that must never be active together."""

    a: str
    b: str
    reason: str
    workaround: str


FEATURES: dict[str, Feature] = {
    f.name: f
    for f in (
        Feature(
            name="adaptive",
            title="schedule `adaptive` (loss-driven partner selection)",
            predicate=lambda c: c.schedule == "adaptive",
            describe=lambda c: "schedule='adaptive' (state-dependent partner selection)",
        ),
        Feature(
            name="compression",
            title="compression `topk` / `qint8` (error feedback)",
            predicate=lambda c: c.compressor != "none",
            describe=lambda c: f"compressor={c.compressor!r} (compressed gossip payloads)",
        ),
        Feature(
            name="staleness",
            title="async `staleness_bound > 0` (bounded-staleness gossip)",
            predicate=lambda c: c.staleness_bound > 0,
            describe=lambda c: f"staleness_bound={c.staleness_bound} (bounded-staleness gossip)",
        ),
        Feature(
            name="async",
            title="async rounds (`--steps-profile` / `--staleness-bound`)",
            predicate=lambda c: c.staleness_bound > 0 or c.steps_profile != "uniform",
            describe=lambda c: "asynchronous rounds (--steps-profile "
                               f"{c.steps_profile}, --staleness-bound "
                               f"{c.staleness_bound})",
        ),
        Feature(
            name="hierarchical",
            title="hierarchical runtime (`--peers-per-device > 1`)",
            predicate=lambda c: c.peers_per_device > 1,
            describe=lambda c: "the hierarchical runtime (peers_per_device "
                               f"= {c.peers_per_device} > 1)",
        ),
        Feature(
            name="real_model",
            title="registry TrainTask (`model != \"mnist_mlp\"`)",
            predicate=lambda c: c.model != "mnist_mlp",
            describe=lambda c: f"model={c.model!r} (a registry TrainTask)",
        ),
    )
}

INCOMPATIBILITIES: tuple[Incompatibility, ...] = (
    Incompatibility(
        a="staleness",
        b="adaptive",
        reason="the adaptive matching is derived from FRESH per-peer losses "
               "every round, which is exactly what a straggler cannot provide",
        workaround="run bounded-staleness gossip on a pretraced schedule, or "
                   "adaptive selection synchronously (staleness_bound=0)",
    ),
    Incompatibility(
        a="staleness",
        b="compression",
        reason="the staleness buffer stores raw sender snapshots while the "
               "compressed wire stores payload-advanced estimates — composing "
               "the two buffers is an open item",
        workaround="run async rounds uncompressed, or compression "
                   "synchronously (staleness_bound=0)",
    ),
    Incompatibility(
        a="adaptive",
        b="hierarchical",
        reason="the adaptive candidate set is the complete graph — dense "
               "O(K^2) matrices the hierarchical runtime's sparse "
               "degree-bounded path exists to avoid",
        workaround="run adaptive schedules with one peer per device "
                   "(peers_per_device=1), or use a pretraced schedule here",
    ),
    Incompatibility(
        a="compression",
        b="hierarchical",
        reason="the hierarchical bridge/segment mixes stream raw fp32 blocks, "
               "not payload-advanced estimates",
        workaround="run compressed gossip with one peer per device "
                   "(peers_per_device=1), or compressor='none' here",
    ),
    Incompatibility(
        a="async",
        b="hierarchical",
        reason="the hierarchical bridge/segment mixes stream live parameter "
               "blocks with no staleness buffer",
        workaround="run async rounds with one peer per device "
                   "(peers_per_device=1), or the uniform synchronous profile "
                   "here",
    ),
    Incompatibility(
        a="real_model",
        b="hierarchical",
        reason="the bridge/segment mixes and their sparse degree-bounded "
               "schedules are validated on the paper's 2NN only; a registry "
               "task's deep parameter tree has no hierarchical parity "
               "baseline yet",
        workaround="run registry tasks with one peer per device "
                   "(peers_per_device=1), or model='mnist_mlp' here",
    ),
)


def format_violation(inc: Incompatibility, ctx: FeatureContext) -> str:
    """The one formatter: every layer's composition error reads identically."""
    a, b = FEATURES[inc.a], FEATURES[inc.b]
    return (f"{a.describe(ctx)} is not supported with {b.describe(ctx)}: "
            f"{inc.reason}; {inc.workaround}")


def active_features(ctx: FeatureContext) -> tuple[str, ...]:
    """Names of the features a context switches on."""
    return tuple(n for n, f in FEATURES.items() if f.predicate(ctx))


def violations(ctx: FeatureContext) -> tuple[Incompatibility, ...]:
    """Table entries whose both features are active in the context."""
    on = set(active_features(ctx))
    return tuple(i for i in INCOMPATIBILITIES if i.a in on and i.b in on)


def check(ctx: FeatureContext) -> None:
    """Raise ``ValueError`` on the first active incompatibility."""
    for inc in violations(ctx):
        raise ValueError(format_violation(inc, ctx))


def check_config(cfg, *, peers_per_device: int = 1) -> None:
    """``check`` over a ``P2PConfig``(-shaped) object run with
    ``peers_per_device`` peers per device, the common entry."""
    check(context_from_config(cfg, peers_per_device=peers_per_device))


def support_matrix_markdown() -> str:
    """The incompatibility table as the README's generated section, one row
    per entry: the reference's string."""
    lines = ["| feature | does not compose with | why |", "|---|---|---|"]
    for inc in INCOMPATIBILITIES:
        lines.append(f"| {FEATURES[inc.a].title} | {FEATURES[inc.b].title} | {inc.reason} |")
    return "\n".join(lines) + "\n"
