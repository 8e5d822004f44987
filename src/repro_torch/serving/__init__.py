"""Request-level serving: the engine (standalone replicas, the fleet slab,
the async tick) and the elastic frontend the control plane drives."""
