"""The fluid cluster simulator, the roofline service rates and the paper's
experiment over them (the port of ``repro.sim``)."""
from repro_torch.sim.cluster import ClusterSim, ClusterState, init_state  # noqa: F401
from repro_torch.sim.service_rate import (  # noqa: F401
    replica_decode_rate, replica_request_rate,
)
