"""Multi-device runs of the port: the sharding rules and placements of a
``ShardPlan`` (``sharding``), elastic remeshing (``elastic``) and the
sequence-sharded decode (``seq_kv``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardPlan, batch_shardings, collective_bytes, comm_bytes, make_shard_fn,
    param_shardings, place_params, serve_state_shardings,
)
from repro_torch.distributed.elastic import (  # noqa: F401
    elastic_remesh, reshard_params, survivors_mesh,
)
