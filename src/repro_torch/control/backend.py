"""The ``ClusterBackend`` protocol: what a cluster must expose for the
control plane to drive it (the port of ``repro.control.backend``).

Two implementations exist:

  * ``SimBackend`` (here) -- wraps ``repro_torch.sim.cluster.ClusterSim``;
    cheap, used for RL training, baseline sweeps and the paper's
    experiment (``repro_torch.sim.experiment``);
  * ``repro_torch.serving.elastic.ElasticClusterFrontend`` -- node groups
    of real ``ReplicaEngine`` model replicas with cold-start provisioning,
    graceful drain and failure injection; used by
    ``repro_torch.launch.serve``.

The per-tick contract (what ``ControlPlane.step`` calls, in order):

    observe(forecast) -> (N, 4+T) features      # Eq.1-3 state
    route(fractions)                             # Eq.4 simplex allocation
    tick(arrival_rate) -> metrics dict           # advance one dt
    scale_to(target)                             # Eq.9 autoscaler plan

plus the read-only views balancers/autoscalers need: ``up_mask``,
``queue_depths``, ``capacity``, ``in_flight`` and ``node_speed``. All of
them are numpy. The metrics dict carries the reference's keys: the tiered
keys (``tier_queue``, ``tier_pressure``, ``tier_slo_cost``, ...) when the
traffic is tiered, and always the robustness keys (``goodput``,
``timed_out``, ``preempt_risk``), the multi-cell keys (``cell_staleness``,
``cell_risk``, ``shed``) and the hierarchy keys (``plane_staleness``,
``lease_util``, ``local_actions``), as identical zeros where they do not
apply; see ``repro.control.backend`` for each key's meaning.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ClusterBackend(Protocol):
    num_nodes: int

    # ------------------------------------------------------------ observe
    def observe(self, forecast: np.ndarray) -> np.ndarray:
        """Per-node features (N, 4+T): [load, util-proxy, cap, up] ++ fc."""
        ...

    def up_mask(self) -> np.ndarray:
        """(N,) 1.0 where the node can serve."""
        ...

    def queue_depths(self) -> np.ndarray:
        """(N,) outstanding work per node (request units)."""
        ...

    def capacity(self) -> np.ndarray:
        """(N,) service capacity per node (work units / tick)."""
        ...

    def in_flight(self) -> np.ndarray:
        """(N,) replicas active + provisioning (the autoscaler's view)."""
        ...

    @property
    def node_speed(self) -> np.ndarray:
        """(N,) relative hardware speed multipliers."""
        ...

    # -------------------------------------------------------------- drive
    def route(self, fractions: np.ndarray) -> None:
        """Set the balancer's simplex allocation for the next tick."""
        ...

    def tick(self, arrival_rate: float) -> dict:
        """Advance one tick under the routed fractions. Returns metrics."""
        ...

    def metrics(self) -> dict:
        """Metrics of the most recent tick."""
        ...

    def scale_to(self, target: np.ndarray) -> None:
        """Apply an autoscaler plan (per-node replica targets)."""
        ...


class SimBackend:
    """``ClusterBackend`` over the fluid simulator."""

    def __init__(self, sim):
        self.sim = sim
        self.num_nodes = sim.cfg.num_nodes
        self._fractions = np.full(self.num_nodes, 1.0 / self.num_nodes,
                                  np.float32)
        self._m: dict = {}

    @property
    def node_speed(self) -> np.ndarray:
        return self.sim.node_speed

    def observe(self, forecast: np.ndarray) -> np.ndarray:
        return self.sim.observation(forecast)

    def up_mask(self) -> np.ndarray:
        return self.sim.state.up.copy()

    def queue_depths(self) -> np.ndarray:
        return self.sim.state.queue.copy()

    def capacity(self) -> np.ndarray:
        return self.sim.capacity()

    def in_flight(self) -> np.ndarray:
        s = self.sim.state
        return s.active + s.pending.sum(axis=1)

    def route(self, fractions: np.ndarray) -> None:
        self._fractions = np.asarray(fractions, np.float32)

    def tick(self, arrival_rate: float) -> dict:
        self._m = self.sim.tick(arrival_rate, self._fractions)
        return self._m

    def metrics(self) -> dict:
        return self._m

    def scale_to(self, target: np.ndarray) -> None:
        self.sim.scale_to(target)
