"""SLO tier specs and the synthetic arrival trace (copies of
``repro.workload.trace``)."""
