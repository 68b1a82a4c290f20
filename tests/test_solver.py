"""BSR matrix, Krylov solver and preconditioner tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from waiwera_tpu.solver import bsr, krylov, precond


def laplacian_1d(n, b=2, seed=0):
    """Block 1-D Laplacian-ish SPD-ish test matrix + structure."""
    rng = np.random.default_rng(seed)
    face_cells = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    structure = bsr.build_structure(n, face_cells, b)
    diag = np.zeros((n, b, b))
    base = 2.0 * np.eye(b) + 0.1 * rng.standard_normal((b, b))
    for i in range(n):
        diag[i] = base * (2.0 + 0.05 * i)
    off = -np.tile(np.eye(b), (n - 1, 1, 1)) * 0.9
    pos_lr, pos_rl = bsr.face_block_positions(structure, face_cells)
    mat = bsr.assemble(
        structure,
        jnp.asarray(diag),
        jnp.asarray(off),
        jnp.asarray(off),
        jnp.asarray(pos_lr),
        jnp.asarray(pos_rl),
    )
    return mat, face_cells


def dense_of(mat):
    s = mat.structure
    n, b = s.num_rows, s.block_size
    d = np.zeros((n * b, n * b))
    rows = np.asarray(s.rows)
    cols = np.asarray(s.indices)
    data = np.asarray(mat.data)
    for k in range(len(rows)):
        i, j = rows[k], cols[k]
        d[i * b : (i + 1) * b, j * b : (j + 1) * b] += data[k]
    return d


def test_spmv_matches_dense():
    mat, _ = laplacian_1d(7, b=3)
    x = np.random.default_rng(1).standard_normal((7, 3))
    y = np.asarray(mat.matvec(jnp.asarray(x)))
    yd = (dense_of(mat) @ x.ravel()).reshape(7, 3)
    np.testing.assert_allclose(y, yd, rtol=1e-12, atol=1e-12)


def test_bicgstab():
    mat, _ = laplacian_1d(50, b=2)
    rng = np.random.default_rng(2)
    xstar = rng.standard_normal((50, 2))
    b = mat.matvec(jnp.asarray(xstar))
    res = krylov.bicgstab(mat.matvec, b, rtol=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6, atol=1e-8)


def test_bicgstab_with_bjacobi():
    mat, _ = laplacian_1d(80, b=3)
    rng = np.random.default_rng(3)
    xstar = rng.standard_normal((80, 3))
    b = mat.matvec(jnp.asarray(xstar))
    pc = precond.block_jacobi(mat)
    res = krylov.bicgstab(mat.matvec, b, precond=pc, rtol=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6, atol=1e-8)


def test_gmres():
    mat, _ = laplacian_1d(40, b=2)
    rng = np.random.default_rng(4)
    xstar = rng.standard_normal((40, 2))
    b = mat.matvec(jnp.asarray(xstar))
    res = krylov.gmres(mat.matvec, b, rtol=1e-10, restart=20)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6, atol=1e-8)


def test_lgmres():
    """LGMRES converges to the exact solution; with augment=0 it
    reduces exactly to plain restarted GMRES (same cycle count)."""
    mat, _ = laplacian_1d(60, b=2)
    rng = np.random.default_rng(7)
    xstar = rng.standard_normal((60, 2))
    b = mat.matvec(jnp.asarray(xstar))
    res = krylov.lgmres(b=b, matvec=mat.matvec, rtol=1e-10, restart=8,
                        augment=2, max_restarts=200)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6,
                               atol=1e-8)
    res0 = krylov.lgmres(b=b, matvec=mat.matvec, rtol=1e-10, restart=8,
                         augment=0, max_restarts=200)
    res_g = krylov.gmres(mat.matvec, b, rtol=1e-10, restart=8,
                         max_restarts=200)
    assert int(res0.iterations) == int(res_g.iterations)


def test_gmres_f32_basis():
    """f32-stored Arnoldi basis (the large-n memory cap,
    timestepper.F90:1840-1851 aux KSP analogue) converges to the same
    solution at the same tolerance as the full-precision basis; H and
    the updates stay f64."""
    mat, _ = laplacian_1d(60, b=2)
    rng = np.random.default_rng(21)
    xstar = rng.standard_normal((60, 2))
    b = mat.matvec(jnp.asarray(xstar))
    res32 = krylov.gmres(
        mat.matvec, b, rtol=1e-10, restart=20,
        basis_dtype=jnp.float32,
    )
    assert bool(res32.converged)
    np.testing.assert_allclose(
        np.asarray(res32.x), xstar, rtol=1e-6, atol=1e-7
    )
    resl = krylov.lgmres(
        b=b, matvec=mat.matvec, rtol=1e-10, restart=10, augment=2,
        max_restarts=200, basis_dtype=jnp.float32,
    )
    assert bool(resl.converged)
    np.testing.assert_allclose(
        np.asarray(resl.x), xstar, rtol=1e-6, atol=1e-7
    )


def test_gmres_basis_memory_policy():
    """The tracer aux solve switches to the f32 basis exactly when the
    f64 workspace would exceed the byte cap (~1M dofs), and a
    million-dof diagonal-dominant solve runs through that path."""
    from waiwera_tpu.sim.tracer import (
        GMRES_BASIS_BYTES_CAP,
        gmres_basis_dtype,
    )

    assert gmres_basis_dtype(10_000, 8) is None
    assert gmres_basis_dtype(2_000_000, 8) == jnp.float32
    # boundary: cap is on bytes of the [31, n] basis
    n_edge = GMRES_BASIS_BYTES_CAP // (31 * 8)
    assert gmres_basis_dtype(n_edge, 8) is None
    assert gmres_basis_dtype(n_edge + 1, 8) == jnp.float32

    # 1.05M-dof smoke solve with the f32 basis (the size class where
    # an f64 basis risked OOM on-device): shifted tridiagonal system,
    # matvec by jnp.roll — converges and matches the known solution
    n = 1_050_000
    rng = np.random.default_rng(5)
    xstar = jnp.asarray(rng.standard_normal(n))

    def mv(x):
        return 4.0 * x - jnp.roll(x, 1) - jnp.roll(x, -1)

    b = mv(xstar)
    res = krylov.gmres(
        mv, b, rtol=1e-8, restart=30, basis_dtype=jnp.float32
    )
    assert bool(res.converged)
    err = float(jnp.max(jnp.abs(res.x - xstar)))
    assert err < 1e-5, err


def test_lgmres_with_precond():
    mat, _ = laplacian_1d(50, b=3)
    rng = np.random.default_rng(8)
    xstar = rng.standard_normal((50, 3))
    b = mat.matvec(jnp.asarray(xstar))
    pc = precond.block_jacobi(mat)
    res = krylov.lgmres(b=b, matvec=mat.matvec, precond=pc, rtol=1e-10,
                        restart=10, augment=3, max_restarts=100)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6,
                               atol=1e-8)


def test_bicgstab_l():
    mat, _ = laplacian_1d(60, b=2)
    rng = np.random.default_rng(9)
    xstar = rng.standard_normal((60, 2))
    b = mat.matvec(jnp.asarray(xstar))
    res = krylov.bicgstab_l(mat.matvec, b, rtol=1e-10, ell=2)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6,
                               atol=1e-8)


def test_bicgstab_l_with_precond():
    mat, _ = laplacian_1d(70, b=3)
    rng = np.random.default_rng(10)
    xstar = rng.standard_normal((70, 3))
    b = mat.matvec(jnp.asarray(xstar))
    pc = precond.make_preconditioner("ilu", mat)
    res = krylov.bicgstab_l(mat.matvec, b, precond=pc, rtol=1e-10,
                            ell=4)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6,
                               atol=1e-8)


def test_solve_dispatch_all_methods():
    mat, _ = laplacian_1d(40, b=2)
    rng = np.random.default_rng(11)
    xstar = rng.standard_normal((40, 2))
    b = mat.matvec(jnp.asarray(xstar))
    for method in ("bcgs", "gmres", "lgmres", "bcgsl"):
        res = krylov.solve(method, mat.matvec, b, rtol=1e-10)
        assert bool(res.converged), method
        np.testing.assert_allclose(
            np.asarray(res.x), xstar, rtol=1e-6, atol=1e-8,
            err_msg=method,
        )


def test_dilu_preconditioner():
    mat, _ = laplacian_1d(60, b=2)
    rng = np.random.default_rng(5)
    xstar = rng.standard_normal((60, 2))
    b = mat.matvec(jnp.asarray(xstar))
    pc = precond.make_preconditioner("ilu", mat)
    res = krylov.bicgstab(mat.matvec, b, precond=pc, rtol=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), xstar, rtol=1e-6, atol=1e-8)
    # DILU should beat plain bjacobi on iteration count
    res_bj = krylov.bicgstab(
        mat.matvec, b, precond=precond.block_jacobi(mat), rtol=1e-10
    )
    assert int(res.iterations) <= int(res_bj.iterations)


def test_diag_blocks():
    mat, _ = laplacian_1d(5, b=2)
    d = np.asarray(mat.diag_blocks())
    dd = dense_of(mat)
    for i in range(5):
        np.testing.assert_allclose(d[i], dd[2 * i : 2 * i + 2, 2 * i : 2 * i + 2])


def test_ell_matvec_matches_bsr():
    from waiwera_tpu.ops import ell

    mat, _ = laplacian_1d(23, b=3)
    es = ell.ell_structure(mat.structure)
    m = ell.to_ell(mat, es)
    x = np.random.default_rng(7).standard_normal((23, 3))
    y_ell = np.asarray(m.matvec(jnp.asarray(x)))
    y_bsr = np.asarray(mat.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y_ell, y_bsr, rtol=1e-13, atol=1e-13)


def test_ell_matvec_2d_mesh_structure():
    """Unstructured-ish pattern: 2D grid + diagonal couplings."""
    from waiwera_tpu.ops import ell

    n = 30
    rng = np.random.default_rng(11)
    faces = []
    for i in range(n):
        for j in rng.choice(n, size=3, replace=False):
            if i != j:
                faces.append((min(i, j), max(i, j)))
    faces = np.unique(np.array(faces), axis=0)
    structure = bsr.build_structure(n, faces, 2)
    data = rng.standard_normal((structure.indices.shape[0], 2, 2))
    mat = bsr.BSRMatrix(structure=structure, data=jnp.asarray(data))
    es = ell.ell_structure(structure)
    m = ell.to_ell(mat, es)
    x = rng.standard_normal((n, 2))
    np.testing.assert_allclose(
        np.asarray(m.matvec(jnp.asarray(x))),
        np.asarray(mat.matvec(jnp.asarray(x))),
        rtol=1e-13,
        atol=1e-13,
    )


def test_bicgstab_float32():
    """Mixed-precision inner solve: f32 Krylov reaches its rtol."""
    from waiwera_tpu.ops import ell

    mat, _ = laplacian_1d(64, b=2)
    es = ell.ell_structure(mat.structure)
    m32 = ell.to_ell(mat, es, dtype=jnp.float32)
    rng = np.random.default_rng(6)
    xstar = rng.standard_normal((64, 2))
    b64 = mat.matvec(jnp.asarray(xstar))
    pc = precond.block_jacobi(mat, dtype=jnp.float32)
    res = krylov.bicgstab(
        m32.matvec, b64.astype(jnp.float32), precond=pc, rtol=1e-5
    )
    assert res.x.dtype == jnp.float32
    assert bool(res.converged)
    # true residual in f64 honours the f32 solve tolerance
    r = np.asarray(b64) - np.asarray(
        mat.matvec(jnp.asarray(np.asarray(res.x), jnp.float64))
    )
    assert np.linalg.norm(r) <= 5e-5 * np.linalg.norm(np.asarray(b64))


def test_gmres_float32():
    from waiwera_tpu.ops import ell

    mat, _ = laplacian_1d(32, b=2)
    es = ell.ell_structure(mat.structure)
    m32 = ell.to_ell(mat, es, dtype=jnp.float32)
    rng = np.random.default_rng(8)
    xstar = rng.standard_normal((32, 2))
    b64 = mat.matvec(jnp.asarray(xstar))
    res = krylov.gmres(
        m32.matvec, b64.astype(jnp.float32), rtol=1e-5, restart=16
    )
    assert res.x.dtype == jnp.float32
    assert bool(res.converged)


def _rect_system(nx=6, ny=5, nz=4):
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation

    mesh = rectangular_mesh(
        [10.0] * nx, [10.0] * ny, [5.0] * nz, origin=[0, 0, -100.0]
    )
    config = {
        "eos": {"name": "we"},
        "initial": {"primary": [2.0e6, 120.0], "region": 1},
        "boundaries": [
            {
                "primary": [2.0e6, 120.0],
                "region": 1,
                "faces": {
                    "cells": list(range(nx * ny)),
                    "normal": [0.0, 0.0, 1.0],
                },
            }
        ],
    }
    return Simulation(config, mesh=mesh)


def test_dia_detection_and_matvec_rect_mesh():
    """On a 3D rect mesh the Jacobian must be detected as banded and
    DIA/ELL/BSR matvecs must agree."""
    import jax
    from waiwera_tpu.ops import dia, ell
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _rect_system()
    system = sim.system
    assert system.dia is not None
    assert len(system.dia.offsets) <= 7 + 2  # {0,±1,±nx,±nx*ny}

    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0),
        dt_eff=jnp.asarray(1e4),
        const=-lhs0,
    )
    _, _, _, _, mat = system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    n = system.mesh.num_cells
    x = np.random.default_rng(3).standard_normal((n, 2))
    xj = jnp.asarray(x)
    y_bsr = np.asarray(mat.matvec(xj))
    y_dia = np.asarray(dia.jnp_matvec(dia.to_dia(mat, system.dia), xj))
    y_ell = np.asarray(ell.to_ell(mat, system.ell).matvec(xj))
    np.testing.assert_allclose(y_dia, y_bsr, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(y_ell, y_bsr, rtol=1e-12, atol=1e-9)


def test_band_plan_pack_matches_gather():
    """The gather-free reshape/pad band pack (bands_from_blocks) must
    produce exactly the bands the BSR-assemble-then-gather path
    (to_dia) does, and linear_operator_from_parts must solve to the
    same answer as make_linear_operator."""
    from waiwera_tpu.ops import dia
    from waiwera_tpu.solver import krylov as _krylov
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _rect_system(6, 5, 4)
    system = sim.system
    assert system.band_plan is not None  # rectilinear: plan must hold

    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    r, _, _, _, parts = system.residual_and_jacobian_parts(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    mat = system.assemble_bsr(parts)
    m_gather = dia.to_dia(mat, system.dia)
    m_plan = dia.bands_from_blocks(
        system.dia, system.band_plan, *parts
    )
    assert m_plan.offsets == m_gather.offsets
    np.testing.assert_allclose(
        np.asarray(m_plan.bands), np.asarray(m_gather.bands),
        rtol=0, atol=0,
    )

    n = system.mesh.num_cells
    v = jnp.asarray(
        np.random.default_rng(7).standard_normal((n, system.npv))
    )
    for pc_name in ("bjacobi", "dilu", "none"):
        mv_a, pc_a = system.make_linear_operator(mat, pc_name)
        mv_b, pc_b = system.linear_operator_from_parts(parts, pc_name)
        np.testing.assert_allclose(
            np.asarray(mv_b(v)), np.asarray(mv_a(v)),
            rtol=1e-12, atol=1e-10,
        )
        np.testing.assert_allclose(
            np.asarray(pc_b(v)), np.asarray(pc_a(v)),
            rtol=1e-10, atol=1e-10,
        )


def test_line_pc_exact_tridiagonal():
    """The z-line preconditioner must solve the {0, +-p} block
    tridiagonal exactly (batched block-Thomas; ops/dia.py
    dia_line_pc_em), p = outermost band."""
    from waiwera_tpu.ops import dia
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _rect_system(6, 5, 4)
    system = sim.system
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    _, _, _, _, parts = system.residual_and_jacobian_parts(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    m64 = dia.bands_from_blocks(system.dia, system.band_plan, *parts)
    pc = dia.dia_line_pc_em(m64)
    n = system.mesh.num_cells
    b = system.npv
    offs = [int(d) for d in m64.offsets]
    p = max(d for d in offs if d > 0 and -d in offs)
    r = np.random.default_rng(3).standard_normal((n, b))
    z = np.asarray(pc(jnp.asarray(r)))
    # dense reference with only the {0, +-p} bands
    A = np.zeros((n * b, n * b))
    bands = np.asarray(m64.bands)
    for k, d in enumerate(offs):
        if d not in (0, p, -p):
            continue
        for i in range(n):
            j = i + d
            if 0 <= j < n:
                A[i * b:(i + 1) * b, j * b:(j + 1) * b] = (
                    bands[k, :, i].reshape(b, b)
                )
    zref = np.linalg.solve(A, r.reshape(-1)).reshape(n, b)
    np.testing.assert_allclose(z, zref, rtol=1e-8, atol=1e-10)


def test_cpr_mg_preconditioner():
    """CPR (pressure-block geometric multigrid + block-Jacobi
    correction, ops/mg.py) must (a) contract the pressure residual
    per V-cycle and (b) cut BiCGStab iteration counts vs plain
    bjacobi while solving to the same accuracy."""
    from waiwera_tpu.ops import dia, mg
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _rect_system(12, 10, 8)
    system = sim.system
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e5), const=-lhs0
    )
    r, _, _, _, parts = system.residual_and_jacobian_parts(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e5),
    )
    m64 = dia.bands_from_blocks(system.dia, system.band_plan, *parts)
    built = mg.pressure_levels(m64)
    assert built is not None
    levels, dims = built
    nz, ny, nx = dims
    rng = np.random.default_rng(0)
    r3 = jnp.asarray(rng.standard_normal((nz, ny, nx)))
    Zp, Yp, Xp = levels[0].d.shape
    r3p = jnp.pad(r3, ((0, Zp - nz), (0, Yp - ny), (0, Xp - nx)))
    z = jnp.zeros_like(r3p)
    norms = []
    for _ in range(4):
        res = r3p - mg._matvec(levels[0], z)
        norms.append(float(jnp.linalg.norm(res)))
        z = z + mg.vcycle(levels, res)
    # contraction on the pressure system every cycle
    assert norms[1] < 0.5 * norms[0], norms
    assert norms[3] < norms[2] < norms[1], norms

    results = {}
    for pcname in ("bjacobi", "cpr"):
        mv, pc = system.linear_operator_from_parts(parts, pcname)
        res = krylov.solve("bcgs", mv, r, precond=pc, rtol=1e-8)
        assert bool(res.converged)
        mv64, _ = system.linear_operator_from_parts(parts, "none")
        resid = float(
            jnp.linalg.norm(mv64(res.x) - r) / jnp.linalg.norm(r)
        )
        assert resid < 1e-6, (pcname, resid)
        results[pcname] = int(res.iterations)
    assert results["cpr"] < results["bjacobi"], results


def test_band_plan_pack_no_padding_slack():
    """Regression: with no boundary ghosts the band width equals the
    cell count (n == n_pad), so the final band segment's q->p
    zero-padding extends past n_pad; the pack must clamp it instead of
    crashing with a negative pad (ops/dia.py bands_from_blocks)."""
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.ops import dia
    from waiwera_tpu.solver.system import MethodCoeffs

    mesh = rectangular_mesh(
        [10.0] * 16, [10.0] * 16, [5.0] * 8, origin=[0, 0, -40.0]
    )
    sim = Simulation(
        {
            "eos": {"name": "we"},
            "initial": {"primary": [2.0e6, 120.0], "region": 1},
        },
        mesh=mesh,
    )
    system = sim.system
    assert system.mesh.num_cells == system.dia.band_pos.shape[1]
    assert system.band_plan is not None

    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    _, _, _, _, parts = system.residual_and_jacobian_parts(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    mat = system.assemble_bsr(parts)
    m_gather = dia.to_dia(mat, system.dia)
    m_plan = dia.bands_from_blocks(system.dia, system.band_plan, *parts)
    np.testing.assert_allclose(
        np.asarray(m_plan.bands), np.asarray(m_gather.bands),
        rtol=0, atol=0,
    )


def _minc_hybrid_sim():
    """Small MINC model whose Jacobian takes the hybrid banded+tail
    path (shared by the hybrid-operator tests)."""
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation

    nx, ny, nz = 6, 4, 4
    mesh = rectangular_mesh(
        [10.0] * nx, [10.0] * ny, [5.0] * nz, origin=[0, 0, -20.0]
    )
    n0 = nx * ny * nz
    config = {
        "eos": {"name": "we"},
        "initial": {"primary": [2.0e6, 120.0], "region": 1},
        "mesh": {
            "zones": {"low": {"type": "box", "z": [-20.0, -10.0]}},
            "minc": {
                # two matrix levels: chain-major cell numbering gives
                # per-parent fracture->matrix offsets, which breaks
                # pure banding and exercises the hybrid tail
                "geometry": {
                    "fracture": {"volume": 0.2, "spacing": 10.0},
                    "matrix": {"volume": [0.3, 0.5]},
                },
                "rock": {"zones": ["low"]},
            },
        },
        "boundaries": [
            {
                "primary": [2.0e6, 120.0],
                "region": 1,
                "faces": {
                    "cells": list(range(n0 - nx * ny, n0)),
                    "normal": [0.0, 0.0, 1.0],
                },
            }
        ],
    }
    return Simulation(config, mesh=mesh)


def test_hybrid_face_plan_minc():
    """MINC meshes (banded fracture lattice + appended matrix chains)
    must take the hybrid path: periodic face plan for the lattice
    prefix, indexed tail for chains/ghosts — and the hybrid operator
    must match the BSR/ELL fallback exactly."""
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _minc_hybrid_sim()
    system = sim.system
    assert system.band_plan is None  # MINC breaks pure banding
    assert system.face_plan is not None  # ...but the hybrid holds
    assert system.hybrid is not None
    assert int(system._tail_cl.shape[0]) > 0

    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    r, _, _, _, parts = system.residual_and_jacobian_parts(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    mat = system.assemble_bsr(parts)
    nrows = system.mesh.num_cells
    v = jnp.asarray(
        np.random.default_rng(11).standard_normal((nrows, system.npv))
    )
    for pc_name in ("bjacobi", "none"):
        mv_a, pc_a = system.make_linear_operator(mat, pc_name)
        mv_b, pc_b = system.linear_operator_from_parts(parts, pc_name)
        np.testing.assert_allclose(
            np.asarray(mv_b(v)), np.asarray(mv_a(v)),
            rtol=1e-12, atol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(pc_b(v)), np.asarray(pc_a(v)),
            rtol=1e-10, atol=1e-10,
        )


def _abs_matvec(mat, x):
    """|A| |x| from assembled BSR data: the scale of each row sum's
    rounding error."""
    return np.asarray(
        bsr.BSRMatrix(structure=mat.structure, data=jnp.abs(mat.data))
        .matvec(jnp.abs(x))
    )


def test_hybrid_operator_f32_matches_bsr():
    """The MINC hybrid operator in f32 (band SpMV plus the indexed
    tail of fracture-matrix faces) agrees with the f64 BSR gather
    matvec to 1e-5 of |A||x| per row (f32 rounding of short row sums
    is below 2e-6 of it)."""
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _minc_hybrid_sim()
    system = sim.system
    assert system.hybrid is not None
    assert int(system._tail_cl.shape[0]) > 0

    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    _, _, _, _, parts = system.residual_and_jacobian_parts(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    mat = system.assemble_bsr(parts)
    mv, _ = system.linear_operator_from_parts(
        parts, "none", dtype=jnp.float32
    )
    v = jnp.asarray(
        np.random.default_rng(23)
        .standard_normal((system.mesh.num_cells, system.npv))
    )
    y = np.asarray(mv(v.astype(jnp.float32)))
    assert y.dtype == np.float32
    y_ref = np.asarray(mat.matvec(v))
    err = np.abs(y - y_ref)
    assert np.all(err <= 1e-5 * _abs_matvec(mat, v) + 1e-30)


def _check_dia_matvec_f32(eos_name, primary):
    """f32 band SpMV of a real Jacobian against the f64 BSR gather
    matvec, per row relative to |A||x|."""
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.ops import dia
    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.solver.system import MethodCoeffs

    nx, ny, nz = 5, 4, 3
    mesh = rectangular_mesh(
        [10.0] * nx, [10.0] * ny, [5.0] * nz, origin=[0, 0, -15.0]
    )
    sim = Simulation(
        {
            "eos": {"name": eos_name},
            "initial": {"primary": primary, "region": 1},
            "boundaries": [
                {
                    "primary": primary,
                    "region": 1,
                    "faces": {
                        "cells": list(range(nx * ny)),
                        "normal": [0.0, 0.0, 1.0],
                    },
                }
            ],
        },
        mesh=mesh,
    )
    system = sim.system
    assert system.dia is not None
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    _, _, _, _, mat = system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    assert mat.structure.block_size == len(primary)
    x = jnp.asarray(
        np.random.default_rng(5).standard_normal(
            (system.mesh.num_cells, len(primary))
        )
    )
    m32 = dia.to_dia(mat, system.dia, dtype=jnp.float32)
    y32 = np.asarray(dia.jnp_matvec(m32, x.astype(jnp.float32)))
    assert y32.dtype == np.float32
    err = np.abs(y32 - np.asarray(mat.matvec(x)))
    assert np.all(err <= 1e-5 * _abs_matvec(mat, x) + 1e-30)


_F32_MATVEC_CASES = [
    ("we", [2.0e6, 120.0]),
    ("wge", [2.0e6, 120.0, 1.0e5]),
    ("wsge", [2.0e6, 120.0, 0.05, 1.0e5]),
]


@pytest.mark.parametrize("eos_name,primary", _F32_MATVEC_CASES)
def test_dia_matvec_f32_matches_bsr_f64(eos_name, primary):
    """Block sizes 2, 3 and 4: the f32 band SpMV (the Krylov operator
    under the mixed-precision policy) agrees with the f64 BSR
    reference to 1e-5 of |A||x| per row. Rounding of a row sum of 7b
    f32 products is below (7b+2)*2^-24 < 2e-6 of it; products taken
    in TF32 (2^-11) would fail."""
    _check_dia_matvec_f32(eos_name, primary)


@pytest.mark.gpu
def test_dia_matvec_f32_on_gpu(gpu_device):
    """The same comparison compiled for the card."""
    for eos_name, primary in _F32_MATVEC_CASES:
        _check_dia_matvec_f32(eos_name, primary)


def test_band_plan_none_on_permuted_mesh():
    """A cell permutation that breaks the periodic-slice structure must
    make band_plan return None (fallback to the gather pack) without
    changing results."""
    from waiwera_tpu.ops import dia

    sim = _rect_system(5, 4, 3)
    system = sim.system
    fc = np.asarray(system.mesh.face_cells).copy()
    # swap the endpoints of one face: orientation mix within a band
    fc[3] = fc[3][::-1]
    plan = dia.band_plan(
        system.dia, fc, np.asarray(system.mesh.is_ghost)
    )
    assert plan is None


def test_dia_dilu_preconditioner():
    """DIA shift-based DILU cuts BiCGStab iterations vs block-Jacobi
    and yields the correct solution."""
    from waiwera_tpu.ops import dia
    from waiwera_tpu.solver.smallblocks import invert_blocks
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _rect_system(8, 7, 5)
    system = sim.system
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    r, _, _, _, mat = system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    m64 = dia.to_dia(mat, system.dia)
    rng = np.random.default_rng(9)
    xstar = jnp.asarray(
        rng.standard_normal((system.mesh.num_cells, 2))
    )
    b = dia.jnp_matvec(m64, xstar)

    pc_bj = dia.dia_block_jacobi(
        invert_blocks(dia.diag_band_blocks(m64))
    )
    res_bj = krylov.bicgstab(m64.matvec, b, precond=pc_bj, rtol=1e-10)
    pc_dilu = dia.dia_dilu(m64, invert_blocks, sweeps=3)
    res_dl = krylov.bicgstab(m64.matvec, b, precond=pc_dilu, rtol=1e-10)
    assert bool(res_dl.converged)
    np.testing.assert_allclose(
        np.asarray(res_dl.x), np.asarray(xstar), rtol=1e-5, atol=1e-7
    )
    assert int(res_dl.iterations) <= int(res_bj.iterations)


def test_make_linear_operator_consistency():
    """system.make_linear_operator's matvec agrees with BSR matvec in
    both precisions."""
    sim = _rect_system(5, 4, 3)
    system = sim.system
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    from waiwera_tpu.solver.system import MethodCoeffs

    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    _, _, _, _, mat = system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    x = np.random.default_rng(4).standard_normal(
        (system.mesh.num_cells, 2)
    )
    for dtype, tol in ((None, 1e-12), (jnp.float32, 2e-5)):
        mv, pc = system.make_linear_operator(mat, "ilu", dtype=dtype)
        y = np.asarray(mv(jnp.asarray(x, dtype or jnp.float64)))
        yd = np.asarray(mat.matvec(jnp.asarray(x)))
        scale = np.abs(yd).max()
        np.testing.assert_allclose(y, yd, rtol=tol, atol=tol * scale)
        z = pc(jnp.asarray(x, dtype or jnp.float64))
        assert np.all(np.isfinite(np.asarray(z)))


def test_jacobian_float32_tangents():
    """f32 Jacobian chain matches the f64 Jacobian to f32 accuracy and
    the residual stays f64."""
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _rect_system(6, 5, 4)
    system = sim.system
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )
    r64, L64, _, _, mat64 = system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
    )
    r32, L32, _, _, mat32 = system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
        tangent_dtype=jnp.float32,
    )
    assert r32.dtype == jnp.float64
    assert mat32.data.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(r32), np.asarray(r64), rtol=1e-12, atol=1e-12
    )
    d64 = np.asarray(mat64.data)
    d32 = np.asarray(mat32.data)
    scale = np.abs(d64).max(axis=(1, 2), keepdims=True) + 1e-30
    np.testing.assert_allclose(d32 / scale, d64 / scale, atol=2e-4)


def test_jacobian_float32_tangents_under_two_jits():
    """Regression for the round-2 bench crash: _mesh_cast used to
    cache traced arrays on self, so the f32-Jacobian path died with an
    UnexpectedTracerError on the SECOND distinct jit that traced it.
    Production use is always under jit, so this must work under two
    different jits on one System instance."""
    import jax
    from waiwera_tpu.solver.system import MethodCoeffs

    sim = _rect_system(6, 5, 4)
    system = sim.system
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    coeffs = MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=jnp.asarray(1e4), const=-lhs0
    )

    @jax.jit
    def jit_a(y):
        out = system.residual_and_jacobian(
            y, sim.region0, sim.rock, coeffs,
            jnp.asarray(0.0), jnp.asarray(1e4),
            tangent_dtype=jnp.float32,
        )
        return out[0], out[4].data

    @jax.jit
    def jit_b(y):
        # different jit, different output shape -> fresh trace
        out = system.residual_and_jacobian(
            y, sim.region0, sim.rock, coeffs,
            jnp.asarray(0.0), jnp.asarray(1e4),
            tangent_dtype=jnp.float32,
        )
        return out[4].data.sum()

    r_a, data_a = jit_a(sim.y0)
    s_b = jit_b(sim.y0)  # used to raise UnexpectedTracerError
    assert np.isfinite(float(s_b))
    np.testing.assert_allclose(
        float(np.asarray(data_a).sum()), float(s_b), rtol=1e-4
    )
    # and eager after jit still works
    out = system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), jnp.asarray(1e4),
        tangent_dtype=jnp.float32,
    )
    assert np.all(np.isfinite(np.asarray(out[4].data)))


def test_newton_with_float32_jacobian_converges():
    """End-to-end Newton step with f32 Jacobian + f32 Krylov reaches
    the same solution as the f64 path."""
    import jax
    from waiwera_tpu.solver.newton import NewtonParams

    sim = _rect_system(6, 5, 4)
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    dt = jnp.asarray(2e4)
    args = (
        sim.y0, sim.region0, fluid0.temperature, lhs0, lhs0,
        jnp.asarray(0.0), dt, dt, jnp.asarray(1.0),
    )
    res64 = sim.make_step_fn(
        NewtonParams(min_iterations=1), "beuler"
    )(*args)[0]
    res32 = sim.make_step_fn(
        NewtonParams(
            min_iterations=1,
            jacobian_dtype="float32",
            linear_dtype="float32",
        ),
        "beuler",
    )(*args)[0]
    assert bool(res64.converged) and bool(res32.converged)
    assert not bool(res32.failed)
    y64 = np.asarray(res64.y)
    y32 = np.asarray(res32.y)
    np.testing.assert_allclose(y32, y64, rtol=2e-5, atol=2e-5)


def test_lu_preconditioner_one_iteration():
    """The dense LU PC (timestepper.F90:1823-1829 PCLU analogue) makes
    BCGS converge in one iteration on a small column model."""
    import jax.numpy as jnp
    from waiwera_tpu.mesh.rect import column_mesh
    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.solver import krylov
    from waiwera_tpu.solver.system import MethodCoeffs

    mesh = column_mesh([10.0] * 24)
    sim = Simulation(
        {
            "eos": {"name": "we"},
            "initial": {"primary": [5.0e6, 180.0], "region": 1},
            "source": [{"cell": 23, "rate": -0.02}],
        },
        mesh=mesh,
    )
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    dt = jnp.asarray(1.0e4)
    coeffs = MethodCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=dt, const=-lhs0)
    r, L, fx, err, mat = sim.system.residual_and_jacobian(
        sim.y0, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt
    )
    mv, pc = sim.system.make_linear_operator(mat, "lu")
    res = krylov.solve("bcgs", mv, -r, precond=pc, rtol=1e-8)
    assert bool(res.converged)
    assert int(res.iterations) <= 2
    np.testing.assert_allclose(
        np.asarray(mv(res.x)), np.asarray(-r), atol=1e-6 * float(
            jnp.max(jnp.abs(r)) + 1.0
        )
    )


@pytest.mark.parametrize("eos_name,primary", [
    ("we", [5.0e6, 180.0]),
    ("wge", [5.0e6, 180.0, 1.0e5]),
])
def test_ad_jacobian_matches_finite_differences(eos_name, primary):
    """FD-by-direction validation mode (SURVEY §7.3): the AD block
    Jacobian agrees with central finite differences of the residual at
    frozen regions (the reference's own Jacobian is built this way,
    timestepper.F90:1584-1607)."""
    import jax.numpy as jnp
    from waiwera_tpu.mesh.rect import column_mesh
    from waiwera_tpu.sim.simulation import Simulation
    from waiwera_tpu.solver.fdcheck import jacobian_fd_error
    from waiwera_tpu.solver.system import MethodCoeffs

    mesh = column_mesh([10.0] * 16)
    sim = Simulation(
        {
            "eos": {"name": eos_name},
            "initial": {"primary": primary, "region": 1},
            "source": [
                {"cell": 15, "rate": -0.01},
                {"cell": 3, "deliverability": {
                    "productivity": 1e-12, "pressure": 1.0e5}},
            ],
        },
        mesh=mesh,
    )
    lhs0, _, _ = sim.lhs_at(sim.y0, sim.region0)
    dt = jnp.asarray(1.0e4)
    coeffs = MethodCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=dt,
                          const=-lhs0)
    err = jacobian_fd_error(
        sim.system, sim.y0, sim.region0, sim.rock, coeffs,
        jnp.asarray(0.0), dt,
    )
    assert err < 1e-5, f"AD vs FD Jacobian relative error {err}"
