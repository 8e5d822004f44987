"""The paper's control-plane algorithms: the GCN (Eq. 6), the DDPG actor
and critic, the GRU demand forecaster, GPSO (Eq. 9-11), the autoscalers and
the balancers (the port of ``repro.core``'s acting half)."""
