"""Core of the port: graphs, consensus, protocols, the P2P round, metrics, tasks.

Exports the reference's ``repro.core`` names (``__all__``, the same set).
They are resolved on first access (PEP 562): ``kernels.consensus_mix``
imports ``core.graph`` and ``core.consensus``, and ``core.protocols``
imports the kernels' wrappers, so a package that imported its modules
eagerly would make the import order matter.  Importing any module of the
port first works.
"""
from __future__ import annotations

import importlib

_FROM = {
    "graph": ("ADAPTIVE_RULES", "SCHEDULES", "TOPOLOGIES", "CommGraph", "GraphSchedule",
              "adaptive_round_matrices", "affinity_matrix", "build_graph",
              "column_stochastic_matrix", "greedy_matching", "link_dropout_schedule",
              "matching_matrices", "mixing_matrix", "one_way_matching_schedule",
              "partner_scores", "peer_churn_schedule", "random_matching_schedule",
              "round_robin_schedule", "schedule_matrices", "spectral_gap", "static_schedule"),
    "protocols": ("ConsensusProtocol", "GossipProtocol", "ProtocolConstants", "PushSumProtocol",
                  "PushSumState", "age_decayed_constants", "get_protocol", "protocol_names",
                  "register_protocol", "round_constants"),
    "p2p": ("ALGORITHMS", "STEPS_PROFILES", "AdaptiveState", "P2PConfig", "P2PState",
            "StalenessState", "build_schedule", "compute_profile", "init_state", "local_phase",
            "consensus_phase", "protocol_constants", "run_round", "make_round_fn",
            "mixing_constants"),
    "metrics": ("RoundLog",),
}
_MODULE_OF = {name: module for module, names in _FROM.items() for name in names}
_SUBMODULES = ("consensus", "protocols")

__all__ = sorted([*_MODULE_OF, *_SUBMODULES])


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
