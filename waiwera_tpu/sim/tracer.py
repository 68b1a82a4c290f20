"""Passive tracers: the auxiliary linear problem.

Counterpart of tracer.F90 and the aux-problem machinery in
flow_simulation.F90:1489-1959 / timestepper.F90:458-557. Per accepted
timestep, solves

    [c_Al Al - dt_eff Ar] x = b

where Al = diag(phi S_p rho_p) per tracer (cell.F90:146-164), Ar has
upstream-weighted advection by the per-phase mass fluxes of the
converged flow solution, harmonic-weighted diffusion
(phi rho_p tau, tau = S_p; cell.F90:168-201, face.F90:519-536),
Arrhenius decay (tracer.F90:48-61), and production sinks; b has
injection sources and the LHS history terms:

  BE:   A = Al(1) - dt Ar(1);             b = Al(0) x(0) + dt br
  BDF2: A = (1+2r) Al(1) - dt (r+1) Ar(1)
        b = (r+1)^2 Al(0) x(0) - r^2 Al(-1) x(-1) + dt (r+1) br

Rows for cells where the tracer phase is absent are replaced by
identity with zero RHS; Dirichlet boundary (ghost) rows hold the
boundary tracer value (flow_simulation.F90:1837-1959). The system is
matrix-free (advection/diffusion are face gather/scatters) and solved
with GMRES + Jacobi using an exactly assembled diagonal, replacing the
reference's AIJ matrix + KSP gmres/bjacobi (timestepper.F90:1840-1851).
Tracers are one-way coupled (flow -> tracer).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from waiwera_tpu.utils.interpolation import InterpolationTable, from_json \
    as table_from_json

Array = jnp.ndarray

# GMRES basis memory cap for the aux solve: the Arnoldi workspace is
# [restart+1, N*nt] values; above this many BYTES in the solve dtype
# (~256 MB, reached near 1M dofs in f64) the basis is stored in f32 —
# H/updates stay f64, the Jacobi-preconditioned aux solve converges
# identically at rtol 1e-5, and a large-mesh tracer model no longer
# risks OOM (timestepper.F90:1840-1851 aux KSP analogue).
GMRES_BASIS_BYTES_CAP = 2**28
_GMRES_RESTART = 30


def gmres_basis_dtype(num_dofs: int, itemsize: int):
    """float32 when the full-precision Arnoldi basis would exceed the
    byte cap, else None (= solve dtype)."""
    if num_dofs * (_GMRES_RESTART + 1) * itemsize > GMRES_BASIS_BYTES_CAP:
        return jnp.float32
    return None

GAS_CONSTANT = 8.3144598  # J/mol/K (thermodynamics.F90:37-41)
TC_K = 273.15


class TracerSet:
    """Host-side tracer definitions (setup_tracers, tracer.F90:65-140)."""

    def __init__(self, cfg, eos):
        if isinstance(cfg, dict):
            cfg = [cfg]
        self.names: List[str] = []
        phase_index = []
        decay = []
        activation = []
        diffusion = []
        phase_names = [p.lower() for p in eos.phase_names]
        default_phase = getattr(eos, "default_tracer_phase", "liquid")
        for i, t in enumerate(cfg or []):
            self.names.append(t.get("name", f"tracer_{i}"))
            ph = str(t.get("phase", default_phase)).lower()
            if ph not in phase_names:
                raise ValueError(f"unknown tracer phase {ph!r}")
            phase_index.append(phase_names.index(ph))
            decay.append(float(t.get("decay", 0.0)))
            activation.append(float(t.get("activation", 0.0)))
            diffusion.append(float(t.get("diffusion", 0.0)))
        self.num_tracers = len(self.names)
        self.phase_index = np.asarray(phase_index, np.int32)
        self.decay_constant = np.asarray(decay)
        self.activation = np.asarray(activation)
        self.diffusion = np.asarray(diffusion)

    def decay_rate(self, temperature: Array) -> Array:
        """[N, nt] Arrhenius decay rate (tracer.F90:48-61)."""
        tk = temperature[:, None] + TC_K
        return jnp.asarray(self.decay_constant) * jnp.exp(
            -jnp.asarray(self.activation) / (GAS_CONSTANT * tk)
        )


class TracerResult(NamedTuple):
    x: Array  # [N, nt]
    al: Array  # [N, nt] balance coefficients at solve state
    converged: Array
    iterations: Array


def balance_coefs(tracers: TracerSet, fluid, rock) -> Array:
    """[N, nt]: phi S_p rho_p for each tracer's phase."""
    p = tracers.phase_index
    sat = fluid.saturation[:, p]
    rho = fluid.density[:, p]
    return rock.porosity[:, None] * sat * rho


def solve(
    tracers: TracerSet,
    mesh,
    fluid,
    rock,
    fluxes: Array,
    npv: int,
    x_last: Array,
    al_last: Array,
    x_last2: Array,
    al_last2: Array,
    c_al: Array,
    dt_eff: Array,
    b_hist: Array,
    source_cell: Optional[Array],
    source_rate: Optional[Array],
    source_frac: Optional[Array],
    tracer_injection: Optional[Array],
    ghost_value: Array,
    rtol: float = 1e-5,
    max_iterations: int = 1000,
    owned: Optional[Array] = None,
    sync=None,
    reduce_sum=None,
    system=None,
) -> TracerResult:
    """One auxiliary solve.

    b_hist: the history part of b ([N, nt], method-dependent, computed
    by the caller from al_last/x_last/al_last2/x_last2).
    source_frac: [ns, nt] tracer-phase flow fractions at source cells.
    tracer_injection: [ns, nt] injection rates.
    ghost_value: [N, nt] Dirichlet values for ghost rows.

    Distributed hooks (parallel.spmd, the aux-solve analogue of the
    reference's parallel KSP gmres+bjacobi, timestepper.F90:1840-1851):
    owned [N] masks rows to the owning device (halo rows stay zero
    through the Krylov iteration), sync is the overlap-1 halo exchange
    applied inside the matvec before face gathers, and reduce_sum
    combines dot products across devices. On a single device all three
    default to identities.
    """
    from waiwera_tpu.solver import krylov

    n = mesh.num_cells
    nt = tracers.num_tracers
    cl = mesh.face_cells[:, 0]
    cr = mesh.face_cells[:, 1]
    area = mesh.face_area
    d12 = jnp.where(mesh.face_distance12 > 0.0, mesh.face_distance12, 1.0)
    vol = jnp.where(mesh.cell_volume > 0.0, mesh.cell_volume, 1.0)
    is_ghost = mesh.is_ghost

    # face gather/scatter: plan-based slicing when the simulation's
    # System detected the periodic face structure (slices stream;
    # indexed gathers and scatter-adds would sit in the aux matvec,
    # which runs once per Krylov iteration)
    if (
        system is not None
        and getattr(system, "face_plan", None) is not None
        and mesh is system.mesh  # the plan was built for system.mesh;
        # a differently-ordered mesh must take the indexed fallback
    ):
        gather_l = lambda a: system.gather_face(a, right=False)
        gather_r = lambda a: system.gather_face(a, right=True)
        scatter2 = lambda va, vb: system.scatter_face_sides(va, vb)
    else:
        gather_l = lambda a: a[cl]
        gather_r = lambda a: a[cr]

        def scatter2(va, vb):
            out = jnp.zeros((n,) + va.shape[1:], va.dtype)
            return out.at[cl].add(va).at[cr].add(vb)

    al = balance_coefs(tracers, fluid, rock)
    pidx = jnp.asarray(tracers.phase_index)
    # per-face tracer-phase mass flux [F, nt]; upstream side = sign
    pf = fluxes[:, npv:][:, pidx]
    up_is_l = pf >= 0.0
    adv = pf * area[:, None]  # [F, nt] mass flow
    # diffusion: harmonic phi rho tau (tau = S), times D / d12 * area
    dfac_cell = (
        rock.porosity[:, None]
        * fluid.density[:, pidx]
        * fluid.saturation[:, pidx]
    )
    f1 = gather_l(dfac_cell)
    f2 = gather_r(dfac_cell)
    wsum = f1 + f2
    dfac = jnp.where(
        jnp.abs(wsum) > 1e-30,
        2.0 * f1 * f2 / jnp.where(jnp.abs(wsum) > 1e-30, wsum, 1.0),
        0.0,
    )
    diff_k = area[:, None] * dfac * jnp.asarray(tracers.diffusion) / d12[
        :, None
    ]  # [F, nt]

    # decay + production diagonals
    decay_diag = -tracers.decay_rate(fluid.temperature) * al  # [N, nt]
    prod_diag = jnp.zeros((n, nt))
    brhs = jnp.zeros((n, nt))
    if source_cell is not None and source_cell.shape[0] > 0:
        producing = source_rate < 0.0
        q_over_v = source_rate / vol[source_cell]
        prod_contrib = jnp.where(
            producing[:, None], source_frac * q_over_v[:, None], 0.0
        )
        prod_diag = prod_diag.at[source_cell].add(prod_contrib)
        inj = jnp.where(
            producing[:, None], 0.0,
            tracer_injection / vol[source_cell][:, None],
        )
        brhs = brhs.at[source_cell].add(inj)

    # tracer phase present? (fluid.phase_composition bitmask)
    present = (
        (fluid.phase_composition[:, None] >> pidx[None, :]) & 1
    ) > 0
    identity_row = (~present) | is_ghost[:, None]
    fixed = jnp.where(is_ghost[:, None], ghost_value, 0.0)

    own = None if owned is None else owned[:, None]
    vol_l = gather_l(vol)
    vol_r = gather_r(vol)

    def ar_matvec(x):
        xl = gather_l(x)
        xr = gather_r(x)
        xu = jnp.where(up_is_l, xl, xr)  # [F, nt] upstream value
        # advection (flow_simulation.F90:1664-1676) + diffusion
        # (:1677-1685), accumulated in one two-sided face scatter
        g = xr - xl
        va = (-adv * xu + diff_k * g) / vol_l[:, None]
        vb = (adv * xu - diff_k * g) / vol_r[:, None]
        return (decay_diag + prod_diag) * x + scatter2(va, vb)

    def a_matvec(x):
        xs = x if sync is None else sync(x)
        ax = c_al * al * xs - dt_eff * ar_matvec(xs)
        ax = jnp.where(identity_row, xs, ax)
        return ax if own is None else jnp.where(own, ax, 0.0)

    b = jnp.where(identity_row, fixed, b_hist + dt_eff * brhs)
    if own is not None:
        b = jnp.where(own, b, 0.0)

    # exact diagonal for Jacobi preconditioning
    va = (jnp.where(up_is_l, -adv, 0.0) - diff_k) / vol_l[:, None]
    vb = (jnp.where(~up_is_l, adv, 0.0) - diff_k) / vol_r[:, None]
    diag_ar = decay_diag + prod_diag + scatter2(va, vb)
    diag = jnp.where(identity_row, 1.0, c_al * al - dt_eff * diag_ar)
    inv_diag = jnp.where(jnp.abs(diag) > 1e-300, 1.0 / diag, 1.0)

    kw = {} if reduce_sum is None else {"reduce_sum": reduce_sum}
    bd = gmres_basis_dtype(b.size, np.dtype(b.dtype).itemsize)
    if bd is not None:
        kw["basis_dtype"] = bd
    res = krylov.solve(
        "gmres",
        a_matvec,
        b,
        precond=lambda v: v * inv_diag,
        rtol=rtol,
        **kw,
    )
    x = res.x if sync is None else sync(res.x)
    return TracerResult(
        x=x, al=al, converged=res.converged, iterations=res.iterations
    )
