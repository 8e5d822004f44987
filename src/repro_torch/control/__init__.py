"""The unified control plane: one forecast -> balance -> scale loop over any
``ClusterBackend`` (the port of ``repro.control``; the multi-cell routing
plane and the two-level hierarchy are not yet ported)."""
from repro_torch.control.backend import ClusterBackend  # noqa: F401
from repro_torch.control.plane import (  # noqa: F401
    METHOD_SPECS, ControlPlane, make_autoscaler,
)
