"""Request-level serving engine (standalone replicas, drain mode)."""
