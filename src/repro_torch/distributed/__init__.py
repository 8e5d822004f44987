"""Multi-device serving of the port: the serve-state and fleet-slab rules
(``sharding``) and the sequence-sharded decode (``seq_kv``)."""
