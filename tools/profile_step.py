"""Time the flagship implicit step end-to-end on the attached device,
plus its in-step stages (residual-only, assembly parts, band pack,
solve) — all consumed on device so nothing big crosses a jit boundary.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp


def _force(x):
    return float(np.asarray(x).reshape(-1)[0])


def timeit(f, reps=3):
    """Device-resident timing (block_until_ready, no device-to-host
    transfer of the fields)."""
    jax.block_until_ready(f())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    nx = int(os.environ.get("BENCH_NX", 128))
    ny = int(os.environ.get("BENCH_NY", 64))
    nz = int(os.environ.get("BENCH_NZ", 64))
    from bench import build_sim
    from waiwera_tpu.solver.newton import NewtonParams
    from waiwera_tpu.solver.system import MethodCoeffs
    from waiwera_tpu.solver import krylov

    sim, n = build_sim(nx, ny, nz)
    npv = sim.eos.num_primary_variables
    system = sim.system
    print(f"cells={n} plan={'yes' if system.band_plan else 'no'}")
    params = NewtonParams(
        max_iterations=8, min_iterations=1,
        linear_dtype="float32", linear_pc=os.environ.get(
            "BENCH_PC", "bjacobi"),
        jacobian_dtype="float32",
    )
    step = sim.make_step_fn(params, "beuler")
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    dt = jnp.asarray(1.0e5)
    t0s = jnp.asarray(0.0)
    ones = jnp.asarray(1.0)
    sargs = (sim.y0, sim.region0, fluid0.temperature, lhs0, lhs0,
             t0s, dt, dt, ones)

    def run_step():
        res, fluid, lhs_new, fluxes = step(*sargs)
        return res.y

    t = timeit(run_step)
    res, _, _, _ = step(*sargs)
    its = int(res.iterations)
    lits = int(res.linear_iterations)
    print(f"step: {t*1e3:9.1f} ms  newton_its={its} linear_its={lits}")
    print(f"dof/s = {n*npv/t:,.0f}")

    coeffs = MethodCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=dt,
                          const=-lhs0)

    # stage: f64 residual only
    @jax.jit
    def resid(y):
        r, L, fx, err = system.residual(
            y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt
        )
        return jnp.sum(r[:1])

    print(f"residual f64:        {timeit(lambda: resid(sim.y0))*1e3:9.1f} ms")

    # stage: residual + jacobian parts (f32 tangents)
    @jax.jit
    def rj(y):
        r, L, fx, err, parts = system.residual_and_jacobian_parts(
            y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt,
            tangent_dtype=jnp.float32,
        )
        return jnp.sum(r[:1]) + jnp.sum(parts[0][:1])

    print(f"resid+jac parts:     {timeit(lambda: rj(sim.y0))*1e3:9.1f} ms")

    # stage: parts -> bands -> one matvec
    @jax.jit
    def packed(y):
        _, _, _, _, parts = system.residual_and_jacobian_parts(
            y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt,
            tangent_dtype=jnp.float32,
        )
        mv, pc = system.linear_operator_from_parts(
            parts, "bjacobi", dtype=jnp.float32
        )
        v = jnp.ones((system.structure.num_rows, npv), jnp.float32)
        return jnp.sum(mv(pc(v))[:1])

    print(f"rj+pack+1 apply:     {timeit(lambda: packed(sim.y0))*1e3:9.1f} ms")

    # stage: full linear solve from parts
    @jax.jit
    def full_lin(y):
        r, _, _, _, parts = system.residual_and_jacobian_parts(
            y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt,
            tangent_dtype=jnp.float32,
        )
        mv, pc = system.linear_operator_from_parts(
            parts, "bjacobi", dtype=jnp.float32
        )
        res = krylov.solve(
            "bcgs", mv, r.astype(jnp.float32), precond=pc, rtol=1e-5
        )
        return jnp.sum(res.x[:1]) + res.iterations.astype(jnp.float32)

    print(f"rj+pack+solve:       {timeit(lambda: full_lin(sim.y0))*1e3:9.1f} ms")


if __name__ == "__main__":
    main()
