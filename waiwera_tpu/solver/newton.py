"""SNES-equivalent Newton solver with phase transitions.

Reproduces the reference's nonlinear solve semantics:
- residual convergence: max_i |r_i| / max(|L_last_i|, f_atol) < f_rtol
  (SNES_convergence, timestepper.F90:1898-1951 via
  vec_max_pointwise_abs_scale, dm_utils.F90:644)
- update convergence: max_i |dy_i| / max(|y_i|, u_atol) <= u_rtol
- minimum-iterations gate; divergence on max iterations or fnorm blowup
- full-step "shell" line search whose post-check applies per-cell
  thermodynamic region transitions, rewriting primaries and regions
  (SNES_linesearch timestepper.F90:673-735 ->
  flow_simulation_fluid_transitions :2419-2576)
- domain errors (EOS out of range, transition failure, primary bounds)
  abort the solve so the timestep can be retried with a smaller dt

The whole solve is one jitted lax.while_loop: Jacobian assembly, Krylov
solve, transitions and convergence checks all stay on device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from waiwera_tpu.solver import krylov, precond
from waiwera_tpu.solver.system import MethodCoeffs, System

Array = jnp.ndarray


class NewtonParams(NamedTuple):
    """Defaults follow timestepper.F90:1567,1998-2002."""

    max_iterations: int = 8
    min_iterations: int = 0
    function_rtol: float = 1e-5
    function_atol: float = 1.0
    update_rtol: float = 1e-10
    update_atol: float = 1.0
    divergence_tol: float = 1e8  # SNES dtol
    linear_method: str = "bcgs"
    linear_pc: str = "bjacobi"
    linear_rtol: float = 1e-5
    linear_max_iterations: int = 1000
    linear_restart: int = 30  # gmres/lgmres subspace size
    linear_augment: int = 2  # lgmres augmentation depth (PETSc default)
    linear_ell: int = 2  # bcgsl polynomial degree (PETSc default)
    pc_sweeps: int = 3
    # per-iteration nonlinear monitor (SNES_monitor,
    # timestepper.F90:1855-1894): jax.debug.print of iteration, scaled
    # residual norm, worst cell and worst equation from inside the
    # jitted loop
    monitor: bool = False
    # precision of the inner Krylov solve. "float32" runs the
    # SpMV/preconditioner loop in f32, halving its bytes; the Newton
    # residual, Jacobian and convergence tests stay f64, so this is
    # classic mixed-precision inexact Newton.
    linear_dtype: str = "float64"
    # precision of the Jacobian tangent chains (EOS/flux derivatives
    # and block assembly). "float32" keeps the residual f64 but
    # assembles the Jacobian in f32 — inexact Newton with ~1e-6
    # -accurate directions (system.residual_and_jacobian).
    jacobian_dtype: str = "float64"


_F32_NAMES = ("float32", "f32", "single")
_F64_NAMES = ("float64", "f64", "double")


def _resolve_dtype(name: str, what: str):
    """f32 -> jnp.float32, f64 -> None (native); anything else is an
    error rather than a silent f64 fallback."""
    if name in _F32_NAMES:
        return jnp.float32
    if name in _F64_NAMES:
        return None
    raise ValueError(
        f"unknown {what} {name!r}: expected one of "
        f"{_F32_NAMES + _F64_NAMES}"
    )


class NewtonResult(NamedTuple):
    y: Array  # [N, npv] solution (scaled primaries)
    region: Array  # [N] final thermodynamic regions
    iterations: Array  # int32
    converged: Array  # bool
    failed: Array  # bool: domain / linear-solver failure
    max_residual: Array  # last scaled residual norm
    linear_iterations: Array  # int32 total
    # worst-residual location (SNES_monitor parity,
    # timestepper.F90:1855-1894): global/natural cell index and
    # equation index of the largest scaled residual component
    worst_cell: Array  # int32
    worst_equation: Array  # int32
    # state at the final iterate, carried out of the loop so the step
    # wrapper does not re-run the f64 EOS chain just to reproduce what
    # the last iteration already computed
    fluid: object = None  # FluidState pytree
    lhs: Array = None  # [N, npv] balances at y
    fluxes: Array = None  # [F, nflux] face fluxes at y


def newton_solve(
    system: System,
    y0: Array,
    region0: Array,
    temperature0: Array,
    rock,
    coeffs: MethodCoeffs,
    t0: Array,
    t1: Array,
    lhs_scale: Array,
    params: NewtonParams = NewtonParams(),
    initial=None,
) -> NewtonResult:
    """Solve r(y) = 0 from initial guess y0.

    lhs_scale: the LHS at the last accepted step (steps%last%lhs) used
    to scale the residual norm. temperature0: fluid temperature at y0
    (for transition fallbacks).

    initial: optional (fluid0, lhs0, fluxes0) evaluated at exactly
    (y0, region0, rock) — normally the previous accepted step's
    outputs, which the timestep loop carries. When given, the pre-loop
    residual reuses them and only re-evaluates the (cheap,
    time-dependent) source-network inflows instead of running the full
    f64 EOS chain at a state whose properties are already known — the
    analogue of the reference's cached balance/flux reuse
    (flow_simulation.F90:851-878, 1429-1444). Callers MUST NOT pass it
    when rock differs from the rock those values were computed with
    (rock controls).
    """
    eos = system.eos
    interior = system.interior_mask

    def any_err(e):
        return system.reduce_any(jnp.any(e & interior))

    def _max_scaled(v: Array, scale: Array, tol: float):
        """max |v| / max(|scale|, tol) over interior dofs
        (vec_max_pointwise_abs_scale), reduced across devices."""
        s = jnp.maximum(jnp.abs(scale), tol)
        vals = jnp.where(interior[:, None], jnp.abs(v) / s, 0.0)
        return system.reduce_max(jnp.max(vals))

    def _max_scaled_loc(v: Array, scale: Array, tol: float):
        """_max_scaled plus the (global cell, equation) of the worst
        component — the reference's per-iteration monitor payload
        (timestepper.F90:1855-1894)."""
        s = jnp.maximum(jnp.abs(scale), tol)
        vals = jnp.where(interior[:, None], jnp.abs(v) / s, 0.0)
        m = jnp.max(vals)
        gm = system.reduce_max(m)
        npv = v.shape[1]
        idx = jnp.argmax(vals)
        cell = (idx // npv).astype(jnp.int32)
        eq = (idx % npv).astype(jnp.int32)
        gcell = system.to_global_cell(cell)
        # only the device holding the global max reports its location
        has_max = m >= gm
        wc = system.reduce_max(jnp.where(has_max, gcell, jnp.int32(-1)))
        we = system.reduce_max(jnp.where(has_max, eq, jnp.int32(-1)))
        return gm, wc, we

    def _fnorm(r: Array):
        return jnp.sqrt(system.reduce_sum(jnp.sum(r * r)))

    if initial is not None:
        fluid0, L0, fx0 = initial
        r0 = system.residual_from_state(fluid0, L0, fx0, coeffs, t0, t1)
        err0 = jnp.zeros_like(region0, dtype=bool)
    else:
        fluid0, cond0, err0 = system.derived_state(y0, region0, rock)
        L0 = system.lhs(fluid0, rock)
        R0, fx0 = system.rhs(fluid0, cond0, rock, t0, t1)
        r0 = coeffs.c_lhs * L0 + coeffs.const - coeffs.dt_eff * R0
    # ghost + (distributed) halo/pad rows are zero, exactly as the
    # loop body's r_new: pad rows would otherwise inject NaN into the
    # Krylov RHS (their EOS state is meaningless)
    r0 = jnp.where(interior[:, None], r0, 0.0)
    fnorm0 = _fnorm(r0)
    maxres0, wc0, we0 = _max_scaled_loc(
        r0, lhs_scale, params.function_atol
    )

    class _State(NamedTuple):
        y: Array
        region: Array
        temperature: Array
        r: Array
        it: Array
        converged: Array
        failed: Array
        max_residual: Array
        linear_its: Array
        worst_cell: Array
        worst_equation: Array
        fluid: object
        lhs: Array
        fluxes: Array

    conv0 = (params.min_iterations <= 0) & (
        maxres0 < params.function_rtol
    )
    if params.monitor:
        jax.debug.print(
            "newton it {it}: maxres {r:.6e} worst cell {c} eq {e}",
            it=0, r=maxres0, c=wc0, e=we0,
        )
    state = _State(
        y=y0,
        region=region0,
        temperature=temperature0,
        r=r0,
        it=jnp.int32(0),
        converged=conv0,
        failed=any_err(err0) | ~jnp.isfinite(fnorm0),
        max_residual=maxres0,
        linear_its=jnp.int32(0),
        worst_cell=wc0,
        worst_equation=we0,
        fluid=fluid0,
        lhs=L0,
        fluxes=fx0,
    )

    def cond(s: _State):
        return (
            (~s.converged)
            & (~s.failed)
            & (s.it < params.max_iterations)
        )

    linear_dtype = _resolve_dtype(params.linear_dtype, "linear_dtype")
    jacobian_dtype = _resolve_dtype(
        params.jacobian_dtype, "jacobian_dtype"
    )
    if jacobian_dtype is not None:
        # an f32 Jacobian cannot back an f64 Krylov solve
        linear_dtype = jacobian_dtype

    def body(s: _State):
        # Jacobian at current iterate (block parts: the banded path
        # packs DIA bands by reshape/pad, skipping the BSR
        # scatter+gather round-trip). The residual at this iterate is s.r,
        # carried from the post-linesearch recompute below (or the
        # pre-loop evaluation), so the Jacobian call does NOT
        # re-evaluate the f64 residual chain; EOS domain errors at
        # this iterate were likewise already checked when s.r was
        # computed (perr below / err0 above).
        with jax.named_scope("jacobian"):
            parts = system.jacobian_parts(
                s.y, s.region, rock, coeffs, t0, t1,
                tangent_dtype=jacobian_dtype,
            )
        with jax.named_scope("linear_solve"):
            mv, pc = system.linear_operator_from_parts(
                parts,
                params.linear_pc,
                dtype=linear_dtype,
                sweeps=params.pc_sweeps,
            )
            b_lin = (
                s.r if linear_dtype is None else s.r.astype(linear_dtype)
            )
            lin = krylov.solve(
                params.linear_method,
                mv,
                b_lin,
                precond=pc,
                rtol=params.linear_rtol,
                max_iterations=params.linear_max_iterations,
                restart=params.linear_restart,
                augment=params.linear_augment,
                ell=params.linear_ell,
                reduce_sum=system.reduce_sum,
            )
        # halo slots of the Krylov solution are not solved locally;
        # pull them from their owner before the pointwise update
        dy = system.sync(lin.x.astype(s.y.dtype))
        y_raw = s.y - dy

        # post-linesearch: transitions + primary bounds (the
        # reference's fluid_trans profiling event)
        with jax.named_scope("fluid_trans"):
            old_primary = eos.unscale(s.y, s.region)
            primary_raw = eos.unscale(y_raw, s.region)
            new_primary, new_region, _, terr = eos.transition(
                old_primary, primary_raw, s.region, s.temperature
            )
            new_primary, bounds_err = eos.check_primary_variables(
                new_primary, new_region
            )
            y_new = eos.scale(new_primary, new_region)
        # ghost rows never move (halo copies of interior cells DO
        # update, consistently with their owner: same pure per-cell
        # transition on synced inputs)
        update = system.update_mask
        y_new = jnp.where(update[:, None], y_new, s.y)
        new_region = jnp.where(update, new_region, s.region)

        # residual at the updated iterate (custom linesearch recompute)
        fluid, cond_, perr = system.derived_state(y_new, new_region, rock)
        L_new = system.lhs(fluid, rock)
        R_new, fx_new = system.rhs(fluid, cond_, rock, t0, t1)
        r_new = coeffs.c_lhs * L_new + coeffs.const - coeffs.dt_eff * R_new
        r_new = jnp.where(interior[:, None], r_new, 0.0)

        it = s.it + 1
        maxres, wc, we = _max_scaled_loc(
            r_new, lhs_scale, params.function_atol
        )
        maxupd = _max_scaled(s.y - y_new, y_new, params.update_atol)
        fnorm = _fnorm(r_new)
        if params.monitor:
            jax.debug.print(
                "newton it {it}: maxres {r:.6e} maxupd {u:.3e} "
                "worst cell {c} eq {e} linear its {li}",
                it=it, r=maxres, u=maxupd, c=wc, e=we,
                li=lin.iterations,
            )

        failed = (
            s.failed
            | any_err(terr)
            | any_err(bounds_err)
            | any_err(perr)
            | ~lin.converged
            | ~jnp.isfinite(fnorm)
            | (fnorm > params.divergence_tol * jnp.maximum(fnorm0, 1e-300))
        )
        converged = (it >= params.min_iterations) & (
            (maxres < params.function_rtol)
            | (maxupd <= params.update_rtol)
        )
        return _State(
            y=y_new,
            region=new_region,
            temperature=fluid.temperature,
            r=r_new,
            it=it,
            converged=converged & ~failed,
            failed=failed,
            max_residual=maxres,
            linear_its=s.linear_its + lin.iterations,
            worst_cell=wc,
            worst_equation=we,
            fluid=fluid,
            lhs=L_new,
            fluxes=fx_new,
        )

    final = lax.while_loop(cond, body, state)
    return NewtonResult(
        y=final.y,
        region=final.region,
        iterations=final.it,
        converged=final.converged,
        failed=final.failed,
        max_residual=final.max_residual,
        linear_iterations=final.linear_its,
        fluid=final.fluid,
        lhs=final.lhs,
        fluxes=final.fluxes,
        worst_cell=final.worst_cell,
        worst_equation=final.worst_equation,
    )
