"""SLO tier specs (a copy of ``repro.workload.trace``'s tier part)."""
