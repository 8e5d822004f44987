"""The port's multi-cell routing plane and two-level hierarchy over fluid
``ClusterSim`` cells, against the reference, on the CPU.

Mirrors the ``ClusterSim`` cases of ``tests/test_cells.py`` (the always-on
degraded-mode keys; a partition's staleness decay and quarantine) and of
``tests/test_hierarchy.py`` (the straggler overlay through the failure
dynamics, lease clamps, a cell controller scaling only inside its lease, a
plane outage aging views without quarantine, plane-down validation, a
supervisor scaling locally through an outage and reconciling, a restore
mid-run continuing the exact decision stream, the hierarchy keys without a
hierarchy), plus a fluid blackout whose evacuated work mass the router
re-injects. Each case runs on both packages with the same inputs (``pkg``
is one package's names) and returns what it observed: the discrete parts
(staleness, plans, leases, replica counts, action ticks) must be equal,
the float parts (router weights, queues, fractions) within 1e-5 relative;
then the reference test's own assertions run on the port's record.
"""
import types

import numpy as np
import pytest

from repro import control as jc
from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.serving import ChaosSchedule as JaxChaos
from repro.sim.cluster import ClusterSim as JaxClusterSim
from repro_torch import control as tc
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.serving.elastic import ChaosSchedule
from repro_torch.sim.cluster import ClusterSim

JAX = types.SimpleNamespace(
    c=jc, Chaos=JaxChaos, Config=JaxClusterConfig,
    Sim=lambda cfg, cap, seed: JaxClusterSim(cfg, cap, seed=seed))
TORCH = types.SimpleNamespace(
    c=tc, Chaos=ChaosSchedule, Config=ClusterConfig,
    Sim=lambda cfg, cap, seed: ClusterSim(cfg, cap, seed=seed, device="cpu"))


def _fluid_cfg(pkg, **kw):
    kw.setdefault("num_nodes", 2)
    kw.setdefault("node_mtbf", 1e12)
    kw.setdefault("straggler_prob", 0.0)
    kw.setdefault("provisioning_delay", 1)
    kw.setdefault("max_replicas_per_node", 4)
    return pkg.Config(**kw)


def _cells(pkg, seeds=(0, 1)):
    return [pkg.Sim(_fluid_cfg(pkg), 2.0, s) for s in seeds]


def _close(got, want, path="record"):
    """Equal structure; ints, bools and strings equal; floats within
    1e-5 relative."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6), path
    else:
        assert got == want, path


def _both(case):
    """Run ``case`` on both packages, hold the port's record to the
    reference's, return the port's."""
    got, want = case(TORCH), case(JAX)
    _close(got, want)
    return got


# ------------------------------------------------------- test_cells.py
def test_degraded_mode_keys_always_on():
    def case(pkg):
        sim = pkg.Sim(pkg.Config(num_nodes=2, node_mtbf=1e12,
                                 straggler_prob=0.0), 2.0, 0)
        m = sim.tick(1.0, np.full(2, 0.5, np.float32))
        return {k: (m[k].tolist() if isinstance(m[k], np.ndarray) else m[k])
                for k in ("cell_staleness", "cell_risk", "shed",
                          "plane_staleness", "lease_util", "local_actions")}

    r = _both(case)
    assert r["cell_staleness"] == [0.0] and r["cell_risk"] == [0.0]
    assert r["shed"] == 0.0 and r["plane_staleness"] == 0.0
    assert r["lease_util"] == [0.0] and r["local_actions"] == 0.0


def test_partition_staleness_decay_and_quarantine():
    def case(pkg):
        cfg = pkg.Config(num_nodes=2, node_mtbf=1e12, straggler_prob=0.0)
        cells = [pkg.Sim(cfg, 2.0, s) for s in (0, 1)]
        mc = pkg.c.MultiCellBackend(
            cells, router=pkg.c.CellRouter(2, max_staleness=2,
                                           confidence_decay=0.5),
            chaos=pkg.Chaos.parse("partition@2:c0:k4"))
        weights, stale, queues = [], [], []
        for t in range(8):
            md = mc.tick(4.0)
            weights.append(float(md["router_weights"][0]))
            stale.append(int(md["cell_staleness"][0]))
            queues.append(md["queue"].copy())
        return {"weights": weights, "stale": stale, "queues": queues,
                "quarantine_ticks": mc.quarantine_ticks,
                "quarantined": mc.metrics()["quarantined"].tolist()}

    r = _both(case)
    w = r["weights"]
    assert r["stale"] == [0, 1, 2, 3, 4, 0, 0, 0]
    assert w[2] < w[1] and w[3] < w[2]
    assert w[4] == 0.0 and w[5] == 0.0 and w[6] > 0.0
    assert r["quarantine_ticks"] == 2
    assert r["quarantined"] == [0.0, 0.0]


def test_fluid_blackout_reinjects_evacuated_mass():
    """cell_down on a fluid cell hands its backlog's work mass to the
    router, which re-injects it into the sibling on the next tick; the
    cell restores through the provisioning pipeline."""
    def case(pkg):
        mc = pkg.c.MultiCellBackend(
            _cells(pkg), chaos=pkg.Chaos.parse("cell_down@3:c0,cell_up@7:c0"))
        served, queues, up, flight = [], [], [], []
        for t in range(10):
            md = mc.tick(12.0)
            served.append(float(md["served"]))
            queues.append(md["queue"].copy())
            up.append(md["up"].tolist())
            flight.append([mc.cell_in_flight(c) for c in range(2)])
        return {"served": served, "queues": queues, "up": up,
                "flight": flight, "downs": mc.cell_downs,
                "backlog": mc._fluid_backlog}

    r = _both(case)
    assert r["downs"] == 1 and r["backlog"] == 0.0
    assert r["up"][3] == [0.0, 1.0] and r["up"][-1] == [1.0, 1.0]
    assert r["flight"][3][0] == 0 and r["flight"][-1][0] > 0


# --------------------------------------------------- test_hierarchy.py
def test_sim_slow_overlay_survives_failure_dynamics():
    def case(pkg):
        sim = pkg.Sim(_fluid_cfg(pkg), 2.0, 0)
        out = [sim.capacity().copy()]
        sim.slow_node(0, 4)
        fr = np.full(2, 0.5, np.float32)
        for _ in range(3):
            sim.tick(1.0, fr)
        out.append(sim.capacity().copy())
        sim.slow_node(0, 1)
        out.append(sim.capacity().copy())
        with pytest.raises(ValueError, match=">= 1"):
            sim.slow_node(0, -2)
        return out

    base, slowed, cleared = _both(case)
    assert slowed[0] == pytest.approx(base[0] / 4)
    assert slowed[1] == pytest.approx(base[1])
    assert cleared[0] == pytest.approx(base[0])


def test_sim_lease_clamps_scale_to():
    def case(pkg):
        sim = pkg.Sim(_fluid_cfg(pkg), 2.0, 0)

        def in_flight():
            s = sim.state
            return int((s.active + s.pending.sum(axis=1)).sum())

        sim.set_lease(0, 3)
        sim.scale_to(np.array([4, 4]))
        a = in_flight()
        sim.set_lease(6, 8)
        sim.scale_to(np.array([1, 1]))
        b = in_flight()
        sim.clear_lease()
        with pytest.raises(ValueError, match="bad lease"):
            sim.set_lease(-1, 2)
        return [a, b]

    assert _both(case) == [3, 6]


def test_cell_controller_scales_only_inside_lease():
    def case(pkg):
        cells = _cells(pkg)
        mc = pkg.c.MultiCellBackend(cells)
        ctl = pkg.c.CellController(mc, 0, patience=1, cooldown=1)
        ctl.step()
        out = {"no_lease_actions": ctl.actions}
        ctl.grant(pkg.c.CellLease(2, 5, 4))
        out["lease"] = cells[0].lease
        for t in range(12):
            cells[0].state.queue[:] = 100.0
            mc.tick(0.0)
            ctl.step()
        out["after_overload"] = mc.cell_in_flight(0)
        out["actions"], out["up_actions"] = ctl.actions, ctl.up_actions
        out["local_total"] = mc.local_actions_total
        for t in range(12):
            cells[0].state.queue[:] = 0.0
            mc.tick(0.0)
            ctl.step()
        out["after_idle"] = mc.cell_in_flight(0)
        out["action_ticks"] = list(ctl.action_ticks)
        return out

    r = _both(case)
    assert r["no_lease_actions"] == 0 and r["lease"] == (2, 5)
    assert r["after_overload"] == 5
    assert r["actions"] > 0 and r["up_actions"] == r["actions"]
    assert r["local_total"] == r["actions"]
    assert r["after_idle"] == 2


def test_plane_outage_ages_views_without_quarantine():
    def case(pkg):
        mc = pkg.c.MultiCellBackend(
            _cells(pkg), router=pkg.c.CellRouter(2, max_staleness=2),
            chaos=pkg.Chaos.parse("plane_down@2:k4"))
        stale, ups, weights = [], [], []
        for t in range(8):
            md = mc.tick(4.0)
            stale.append(int(md["plane_staleness"]))
            ups.append(md["up"].tolist())
            weights.append(md["router_weights"].copy())
        return {"stale": stale, "ups": ups, "weights": weights,
                "quarantine_ticks": mc.quarantine_ticks,
                "outages": mc.plane_outages,
                "outage_ticks": mc.plane_outage_ticks,
                "quarantined": mc.metrics()["quarantined"].tolist()}

    r = _both(case)
    assert r["stale"] == [0, 1, 2, 3, 4, 0, 0, 0]
    assert all(u == [1.0, 1.0] for u in r["ups"])
    assert r["quarantine_ticks"] == 0
    assert all(w.sum() == pytest.approx(1.0) for w in r["weights"])
    assert r["outages"] == 1 and r["outage_ticks"] == 4
    assert r["quarantined"] == [0.0, 0.0]


def test_plane_down_validation():
    def case(pkg):
        mc = pkg.c.MultiCellBackend(_cells(pkg, (0,)))
        with pytest.raises(ValueError, match="not down"):
            mc.plane_up()
        mc.plane_down(None)
        alive = [mc.plane_alive]
        with pytest.raises(ValueError, match="already down"):
            mc.plane_down(3)
        mc.plane_up()
        alive.append(mc.plane_alive)
        mc.plane_down(0)
        alive.append(mc.plane_alive)
        return {"alive": alive, "outages": mc.plane_outages}

    assert _both(case) == {"alive": [False, True, True], "outages": 1}


def test_supervisor_outage_local_scaling_and_reconcile():
    def case(pkg):
        mc = pkg.c.MultiCellBackend(
            _cells(pkg), chaos=pkg.Chaos.parse("plane_down@6:k6"))
        planner = pkg.c.GlobalPlanner(2, total_budget=8, max_per_cell=8,
                                      lease_slack=0.5)
        ctls = [pkg.c.CellController(mc, c, patience=1, cooldown=1)
                for c in range(2)]
        sup = pkg.c.PlaneSupervisor(mc, planner, ctls, plan_interval=5)
        for t in range(20):
            sup.step(4.0 if t < 5 else 80.0)
        return {"plan_log": sup.plan_log, "restores": sup.restores,
                "outage_steps": sup.outage_steps,
                "outage_ticks": mc.plane_outage_ticks,
                "action_ticks": [list(c.action_ticks) for c in ctls],
                "local": [sup.local_actions(), mc.local_actions_total],
                "leases": [c.lease.astuple() for c in ctls],
                "flight": [mc.cell_in_flight(c) for c in range(2)],
                "summary": sup.summary()}

    r = _both(case)
    dark = set(range(6, 12))
    plan_ticks = [t for t, _ in r["plan_log"]]
    assert not set(plan_ticks) & dark
    assert 12 in plan_ticks and r["restores"] == 1
    assert r["outage_steps"] == 5 and r["outage_ticks"] == 6
    assert any(t in dark for ticks in r["action_ticks"] for t in ticks)
    assert r["local"][0] == r["local"][1] > 0
    for (lo, hi, _), f in zip(r["leases"], r["flight"]):
        assert f <= hi


def _fluid_hier(pkg):
    mc = pkg.c.MultiCellBackend(_cells(pkg))
    cfg = pkg.Config(num_nodes=2, horizon=4, forecast_window=8,
                     node_mtbf=1e12, straggler_prob=0.0)
    kw = {} if pkg is JAX else {"device": "cpu"}
    plane = pkg.c.ControlPlane(cfg, mc, balancer="rr", scaler="none",
                               unit_capacity=1.0, init_arrival=4.0, **kw)
    sup = pkg.c.PlaneSupervisor(
        mc, pkg.c.GlobalPlanner(2, total_budget=8, max_per_cell=8),
        [pkg.c.CellController(mc, c) for c in range(2)], plane=plane,
        plan_interval=4)
    return mc, plane, sup, cfg, kw


def test_restore_mid_run_continues_exact_decision_stream():
    rates = [4.0, 9.0, 2.0, 7.0] * 4

    def case(pkg):
        mc_a, plane_a, sup_a, _, _ = _fluid_hier(pkg)
        frac_a = []
        for r in rates:
            sup_a.step(r)
            frac_a.append(plane_a.fractions.copy())
        mc_b, plane_b, sup_b, cfg, kw = _fluid_hier(pkg)
        frac_b = []
        for r in rates[:8]:
            sup_b.step(r)
            frac_b.append(plane_b.fractions.copy())
        ckpt = sup_b.checkpoint()
        plane_b2 = pkg.c.ControlPlane(cfg, mc_b, balancer="rr",
                                      scaler="none", unit_capacity=1.0,
                                      init_arrival=4.0, **kw)
        sup_b2 = pkg.c.PlaneSupervisor(
            mc_b, pkg.c.GlobalPlanner(2, total_budget=8, max_per_cell=8),
            [pkg.c.CellController(mc_b, c) for c in range(2)],
            plane=plane_b2, plan_interval=4)
        sup_b2.restore(ckpt)
        for r in rates[8:]:
            sup_b2.step(r)
            frac_b.append(plane_b2.fractions.copy())
        ma, mb = mc_a.metrics(), mc_b.metrics()
        return {"plans_a": sup_a.plan_log,
                "plans_b": sup_b.plan_log + sup_b2.plan_log,
                "frac_a": frac_a, "frac_b": frac_b,
                "queue": [ma["queue"], mb["queue"]],
                "active": [ma["active_replicas"].tolist(),
                           mb["active_replicas"].tolist()],
                "leases": [[c.lease for c in mc_a.cells],
                           [c.lease for c in mc_b.cells]]}

    r = _both(case)
    assert r["plans_a"] == r["plans_b"]
    assert all(np.array_equal(a, b) for a, b in zip(r["frac_a"],
                                                    r["frac_b"]))
    assert np.array_equal(*r["queue"])
    assert r["active"][0] == r["active"][1]
    assert r["leases"][0] == r["leases"][1]


def test_hierarchy_keys_zero_without_hierarchy():
    def case(pkg):
        mc = pkg.c.MultiCellBackend(_cells(pkg))
        md = mc.tick(2.0)
        out = {"plane_staleness": md["plane_staleness"],
               "lease_util": md["lease_util"].tolist(),
               "local_actions": md["local_actions"]}
        pkg.c.CellController(mc, 0).grant(pkg.c.CellLease(1, 8, 4))
        md = mc.tick(2.0)
        out["granted"] = md["lease_util"].tolist()
        out["in_flight"] = mc.cell_in_flight(0)
        return out

    r = _both(case)
    assert r["plane_staleness"] == 0.0 and r["local_actions"] == 0.0
    assert r["lease_util"] == [0.0, 0.0]
    assert r["granted"][0] == pytest.approx(r["in_flight"] / 8.0)
    assert r["granted"][1] == 0.0

