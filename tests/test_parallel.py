"""Distributed (shard_map) timestep vs the single-device step.

The reference exercises its MPI path by running every unit test at
np=1..4 (unit_tests.py:29-37); here the same physics step runs over an
8-device mesh via waiwera_tpu.parallel and must match the single-device
result to tight tolerance.
"""

import numpy as np
import pytest


def _build_sim(n=48):
    import jax.numpy as jnp

    from waiwera_tpu.mesh.rect import column_mesh
    from waiwera_tpu.sim.simulation import Simulation

    mesh = column_mesh([10.0] * n)
    config = {
        "eos": {"name": "we"},
        "initial": {"primary": [5.0e6, 170.0], "region": 1},
        "source": [
            {"cell": n - 1, "rate": -0.01},
            {"cell": n // 2, "rate": 0.005, "enthalpy": 1.0e6},
        ],
        "boundaries": [
            {
                "primary": [5.0e6, 170.0],
                "region": 1,
                "faces": {"cells": [0], "normal": [0.0, 1.0]},
            }
        ],
        "time": {"step": {"size": 1.0e4}},
    }
    return Simulation(config, mesh=mesh)


def test_partition_plan_covers_mesh():
    from waiwera_tpu.parallel import build_partition

    sim = _build_sim(37)
    plan = build_partition(sim.mesh, 8)
    n = sim.mesh.num_cells
    # every cell owned exactly once
    owned = [
        plan.local_cells[d, i]
        for d in range(8)
        for i in range(plan.n_local)
        if plan.owned_mask[d, i]
    ]
    assert sorted(owned) == list(range(n))
    # round trip through cell_device/cell_slot
    for g in range(n):
        d, s = plan.cell_device[g], plan.cell_slot[g]
        assert plan.local_cells[d, s] == g and plan.owned_mask[d, s]
    # halo slots reference real cells of other devices
    for d in range(8):
        for h in range(plan.n_halo):
            src = plan.recv_src[d, h]
            od, pos = divmod(int(src), plan.num_send)
            g = plan.local_cells[od, plan.send_idx[od, pos]]
            assert plan.owned_mask[od, plan.send_idx[od, pos]]


def test_rcb_splits_ties_along_lowest_axis():
    """Recursive coordinate bisection of a 2:1:1 box into four parts
    gives four congruent x-slabs even when centroid rounding makes the
    y extent of one half a hair longer than its x extent; congruent
    slabs keep the device-uniform banded face plan."""
    from waiwera_tpu.parallel.partition import _rcb

    nx, ny, nz = 8, 4, 4
    k, j, i = np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
    )
    cent = np.stack(
        [50.0 * (i + 0.5), 50.0 * (j + 0.5) * (1.0 + 1e-15),
         20.0 * (k + 0.5)], axis=-1,
    ).reshape(-1, 3)
    parts = _rcb(cent, np.arange(len(cent)), 4)
    for d, ids in enumerate(parts):
        assert len(ids) == nx * ny * nz // 4
        assert set(i.reshape(-1)[ids]) == {2 * d, 2 * d + 1}


def test_p2p_rounds_cover_halo():
    """The edge-colored ppermute rounds deliver exactly the halo:
    simulating the rounds on host must reproduce every device's halo
    slots from the owners' data, each round a partial permutation."""
    from waiwera_tpu.parallel import build_partition

    sim = _build_sim(37)
    plan = build_partition(sim.mesh, 8)
    D = plan.num_devices
    # each round: every device sends to <=1 target, receives from <=1
    for perm in plan.p2p_perms:
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        assert len(set(srcs)) == len(srcs)
        assert len(set(dsts)) == len(dsts)
    # simulate: device value = global cell id of each owned slot
    val = np.full((D, plan.n_local + 1), -1, np.int64)
    for d in range(D):
        val[d, : plan.n_local] = np.where(
            plan.owned_mask[d], plan.local_cells[d], -1
        )
    for r, perm in enumerate(plan.p2p_perms):
        bufs = {s: val[s, plan.p2p_send[s, r]] for s, _ in perm}
        for s, d in perm:
            slots = plan.p2p_recv[d, r]
            val[d][slots] = bufs[s]  # pad slot n_local absorbs junk
    # every halo slot now holds its own global cell id
    for d in range(D):
        halo = np.arange(plan.n_owned_pad, plan.n_local)
        real = ~plan.owned_mask[d, halo] & (
            np.isin(plan.local_cells[d, halo],
                    plan.local_cells[d, : plan.n_owned_pad][
                        plan.owned_mask[d, : plan.n_owned_pad]],
                    invert=True)
        )
        # slots that are genuine halo entries (appear in recv tables)
        received = val[d, halo] >= 0
        assert np.all(
            val[d, halo][received]
            == plan.local_cells[d, halo][received]
        )
        # all halo cells referenced by local faces must be received
        fc = plan.face_cells_local[d][plan.face_mask[d]]
        used = np.unique(fc.ravel())
        used_halo = used[used >= plan.n_owned_pad]
        assert np.all(val[d, used_halo] == plan.local_cells[d, used_halo])


def test_unstructured_partition_graph_and_local_rcm():
    """On a genuinely unstructured mesh the native graph partitioner +
    local RCM ordering produce a valid plan: full ownership coverage,
    consistent p2p halo delivery, and per-device local bandwidth no
    worse than natural order."""
    from waiwera_tpu.mesh.exodus import read_exodus
    from waiwera_tpu.parallel import build_partition

    mesh = read_exodus(
        "/root/reference/test/benchmark/minc/production3d/run/"
        "gminc_3d_refined.exo"
    )
    D = 8
    plan = build_partition(mesh, D)
    n = mesh.num_cells
    owned = [
        plan.local_cells[d, i]
        for d in range(D)
        for i in range(plan.n_local)
        if plan.owned_mask[d, i]
    ]
    assert sorted(owned) == list(range(n))
    # balance: no device more than 2x the ideal share
    sizes = np.asarray(plan.n_owned)
    assert sizes.min() > 0 and sizes.max() <= 2.0 * n / D
    # simulate the p2p rounds: every face-referenced halo slot filled
    val = np.full((D, plan.n_local + 1), -1, np.int64)
    for d in range(D):
        val[d, : plan.n_local] = np.where(
            plan.owned_mask[d], plan.local_cells[d], -1
        )
    for r, perm in enumerate(plan.p2p_perms):
        bufs = {s: val[s, plan.p2p_send[s, r]] for s, _ in perm}
        for s, d in perm:
            val[d][plan.p2p_recv[d, r]] = bufs[s]
    for d in range(D):
        fc = plan.face_cells_local[d][plan.face_mask[d]]
        used = np.unique(fc.ravel())
        used_halo = used[used >= plan.n_owned_pad]
        assert np.all(val[d, used_halo] == plan.local_cells[d, used_halo])


@pytest.mark.parametrize("num_devices", [2, 8])
def test_distributed_step_matches_single(num_devices):
    import jax.numpy as jnp

    from waiwera_tpu.parallel import DistributedSystem
    from waiwera_tpu.solver.newton import NewtonParams

    sim = _build_sim(48)
    params = NewtonParams(max_iterations=8, linear_pc="bjacobi")
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    args_g = (
        sim.y0,
        sim.region0,
        fluid0.temperature,
        lhs0,
        lhs0,
    )
    scal = (
        jnp.asarray(0.0),
        jnp.asarray(1.0e4),
        jnp.asarray(1.0e4),
        jnp.asarray(1.0),
    )

    step1 = sim.make_step_fn(params, "beuler")
    res1, fluid1, lhs1, _ = step1(*args_g, *scal)
    assert bool(res1.converged)

    dist = DistributedSystem(sim, num_devices)
    stepD = dist.make_step_fn(params, "beuler")
    argsl = tuple(dist.to_local(a) for a in args_g)
    resD, fluidD, lhsD, _ = stepD(*argsl, *scal)
    assert bool(resD.converged)
    assert int(resD.iterations) == int(res1.iterations)

    y_d = dist.from_local(resD.y)
    np.testing.assert_allclose(
        np.asarray(y_d), np.asarray(res1.y), rtol=1e-8, atol=1e-10
    )
    reg_d = dist.from_local(resD.region)
    np.testing.assert_array_equal(
        np.asarray(reg_d), np.asarray(res1.region)
    )
    lhs_d = dist.from_local(lhsD)
    np.testing.assert_allclose(
        np.asarray(lhs_d), np.asarray(lhs1), rtol=1e-7, atol=1e-12
    )


@pytest.mark.parametrize("pc", ["asm", "bjacobi"])
def test_distributed_dilu_matches_single(pc):
    """The distributed DILU (restricted additive Schwarz with overlap-1
    halos) must converge to the same answer as the single-device solve
    and not blow up the Krylov iteration count
    (timestepper.F90:1743-1835 ASM default)."""
    import jax.numpy as jnp

    from waiwera_tpu.parallel import DistributedSystem
    from waiwera_tpu.solver.newton import NewtonParams

    sim = _build_sim(48)
    params = NewtonParams(max_iterations=8, linear_pc=pc)
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    args_g = (sim.y0, sim.region0, fluid0.temperature, lhs0, lhs0)
    scal = (
        jnp.asarray(0.0),
        jnp.asarray(1.0e4),
        jnp.asarray(1.0e4),
        jnp.asarray(1.0),
    )
    step1 = sim.make_step_fn(params, "beuler")
    res1, _, _, _ = step1(*args_g, *scal)
    assert bool(res1.converged)

    dist = DistributedSystem(sim, 4)
    stepD = dist.make_step_fn(params, "beuler")
    argsl = tuple(dist.to_local(a) for a in args_g)
    resD, _, _, _ = stepD(*argsl, *scal)
    assert bool(resD.converged)
    y_d = dist.from_local(resD.y)
    # RAS-DILU is a different (equally strong) preconditioner than the
    # single-domain DILU, so agreement is to Newton tolerance
    np.testing.assert_allclose(
        np.asarray(y_d), np.asarray(res1.y), rtol=3e-6, atol=1e-8
    )
    # local DILU with overlap-1 halos must stay within ~2x of the
    # single-domain DILU iteration count
    assert int(resD.linear_iterations) <= 2 * int(res1.linear_iterations) + 8


def test_distributed_source_network_matches_single():
    """Groups + reinjectors + deliverability + separators distributed
    over 8 devices: masked-psum state replication must reproduce the
    single-device network exactly."""
    import jax.numpy as jnp

    from waiwera_tpu.mesh.rect import column_mesh
    from waiwera_tpu.parallel import DistributedSystem
    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.solver.newton import NewtonParams

    n = 40
    mesh = column_mesh([10.0] * n)
    config = {
        "eos": {"name": "we"},
        "initial": {"primary": [10.0e6, 250.0], "region": 1},
        "source": [
            {
                "name": "p1",
                "cell": 5,
                "deliverability": {"productivity": 1e-15,
                                   "pressure": 2e5},
                "separator": {"pressure": 0.55e6},
            },
            {
                "name": "p2",
                "cell": 35,
                "deliverability": {"productivity": 1e-15,
                                   "pressure": 2e5},
                "separator": {"pressure": 0.55e6},
            },
            {"name": "i1", "cell": 20, "rate": 0.05, "enthalpy": 400e3,
             "direction": "injection"},
        ],
        "network": {
            "group": [
                {"name": "wells", "in": ["p1", "p2"],
                 "limiter": {"type": "total", "limit": 100.0}}
            ],
            "reinject": [
                {
                    "name": "r1",
                    "in": "wells",
                    "water": [{"out": "i1", "proportion": 0.5}],
                }
            ],
        },
        "time": {"step": {"size": 1.0e3}},
    }
    sim = Simulation(config, mesh=mesh)
    params = NewtonParams(max_iterations=8, linear_pc="asm")
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    args_g = (sim.y0, sim.region0, fluid0.temperature, lhs0, lhs0)
    scal = (
        jnp.asarray(0.0),
        jnp.asarray(1.0e3),
        jnp.asarray(1.0e3),
        jnp.asarray(1.0),
    )
    step1 = sim.make_step_fn(params, "beuler")
    res1, fluid1, _, _ = step1(*args_g, *scal)
    assert bool(res1.converged)

    dist = DistributedSystem(sim, 8)
    stepD = dist.make_step_fn(params, "beuler")
    argsl = tuple(dist.to_local(a) for a in args_g)
    resD, fluidD, _, _ = stepD(*argsl, *scal)
    assert bool(resD.converged)
    y_d = dist.from_local(resD.y)
    np.testing.assert_allclose(
        np.asarray(y_d), np.asarray(res1.y), rtol=3e-6, atol=1e-8
    )
    # source rates: wells producing; reinjection feeds i1, capped at
    # its specified rate (source_network_reinjector.F90:199-215)
    q1, _ = sim.sources.flows(fluid1, 0.0, 1.0e3)
    qn = np.asarray(q1)
    assert qn[0] < 0 and qn[1] < 0  # producing
    qw_total = float(np.sum(np.asarray(sim.sources._last_separated[0])))
    assert abs(qn[2] - min(0.5 * abs(qw_total), 0.05)) < 1e-12


def test_distributed_timestepper_end_to_end(tmp_path):
    """The full production path over 4 devices: Timestepper (adaptive
    stepping + retry ladder) + tracer aux solves + sources + HDF5
    output, vs the same model single-device. Histories must agree to
    solver tolerance and output must come back in natural cell order
    (the reference runs the same model at any np)."""
    import h5py

    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.sim.timestepper import Timestepper
    from waiwera_tpu.sim.output import HDF5Output
    from waiwera_tpu.mesh.rect import column_mesh
    from waiwera_tpu.parallel import DistributedSimulation

    n = 32
    config = {
        "eos": {"name": "we"},
        "initial": {"primary": [8.0e6, 200.0], "region": 1,
                    "tracer": 0.0},
        "tracer": {"name": "t1", "phase": "liquid", "decay": 1e-8},
        "source": [
            {"cell": n - 1, "rate": -0.02},
            {"cell": 3, "rate": 0.01, "enthalpy": 500.0e3,
             "tracer": {"t1": 1e-6}},
        ],
        "boundaries": [
            {
                "primary": [8.0e6, 200.0],
                "region": 1,
                "faces": {"cells": [0], "normal": [0.0, 1.0]},
            }
        ],
        "time": {
            "stop": 2.0e5,
            "step": {
                "size": 2.0e4,
                "adapt": {"on": True, "minimum": 2, "maximum": 6},
                "maximum": {"number": 40},
            },
        },
        "output": {"frequency": 1},
    }

    def run(sim, fname):
        out = HDF5Output(str(fname), sim)
        ts = Timestepper(config, sim, output=out)
        ok = ts.run()
        out.close()
        assert ok
        return ts

    sim1 = Simulation(config, mesh=column_mesh([10.0] * n))
    run(sim1, tmp_path / "single.h5")

    simd = DistributedSimulation(
        Simulation(config, mesh=column_mesh([10.0] * n)), 4
    )
    run(simd, tmp_path / "dist.h5")

    with h5py.File(tmp_path / "single.h5") as f1, h5py.File(
        tmp_path / "dist.h5"
    ) as f2:
        t1 = np.asarray(f1["time"])
        t2 = np.asarray(f2["time"])
        np.testing.assert_allclose(t2, t1, rtol=1e-12)
        for name in ("fluid_pressure", "fluid_temperature",
                     "fluid_vapour_saturation", "tracer_t1"):
            a = np.asarray(f1["cell_fields"][name])
            b = np.asarray(f2["cell_fields"][name])
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-10,
                                       err_msg=name)
        for name in ("source_rate", "source_enthalpy",
                     "source_tracer_flow"):
            a = np.asarray(f1["source_fields"][name])
            b = np.asarray(f2["source_fields"][name])
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-12,
                                       err_msg=name)
