"""SLO tier specs, the synthetic arrival trace, the forecaster's training
windows and the closed-loop client pool (copies of ``repro.workload.trace``
and ``repro.workload.clients``)."""
from repro_torch.workload.clients import ClientPool  # noqa: F401
from repro_torch.workload.trace import (  # noqa: F401
    DEFAULT_TIERS, LOAD_LEVELS, TierSet, TierSpec, TraceConfig,
    generate_trace, make_forecast_dataset, parse_tiers,
)
