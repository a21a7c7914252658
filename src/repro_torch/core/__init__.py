"""Core of the port: graphs, consensus, protocols, the P2P round, metrics, tasks."""
