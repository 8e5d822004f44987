"""SLO tier specs, the synthetic arrival trace and the closed-loop client
pool (copies of ``repro.workload.trace`` and ``repro.workload.clients``)."""
