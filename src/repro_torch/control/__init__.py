"""The unified control plane: one forecast -> balance -> scale loop over any
``ClusterBackend`` -- the fluid ``ClusterSim`` and the request-level
``ElasticClusterFrontend`` alike -- the multi-cell routing plane and the
two-level control hierarchy (the port of ``repro.control``)."""
from repro_torch.control.backend import ClusterBackend, SimBackend  # noqa: F401
from repro_torch.control.cells import (  # noqa: F401
    CellRouter, MetricsView, MultiCellBackend,
)
from repro_torch.control.hierarchy import (  # noqa: F401
    CellController, CellLease, GlobalPlanner, PlaneSupervisor,
)
from repro_torch.control.plane import (  # noqa: F401
    METHOD_SPECS, ControlPlane, make_autoscaler,
)
