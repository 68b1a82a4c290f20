"""Benchmark: full nonlinear timestep throughput at production scale.

Flagship model (BASELINE.md north star): a 3D water+CO2+energy
(eos_wge, 3 unknowns/cell) box reservoir — default 512k cells / 1.57M
unknowns — with an atmosphere-pressure boundary on the top surface,
a deliverability production well and a cold reinjection well. One
implicit timestep = residuals + AD block-Jacobian + BiCGStab Krylov
solves + phase-transition passes, all on the attached accelerator.

Timing methodology: every measured region ends in block_until_ready
with the state left on the device. Sub-millisecond ops (SpMV, copy)
are chained inside one jit via lax.fori_loop and measured by the slope
between two chain lengths, which cancels launch and host overheads.

Reported alongside the headline dof/s (extra keys in the same JSON
line):
- stage breakdown measured ON DEVICE with scalar-only outputs
  (residual_f64_seconds, jacobian_parts_seconds, linear_solve_*),
  plus their per-Newton-iteration sum vs the step for
  self-consistency (stage_sum_seconds vs step_seconds).
- preconditioner comparison: bjacobi vs dilu (the reference default
  ASM/ILU(0) analogue, timestepper.F90:2019-2022) wall time and
  iteration counts on the same system.
- spmv_nnz_per_s + spmv_roofline_fraction vs bandwidth MEASURED with
  a plain-JAX scale-copy chain in the same process.
- dtype policy table (flagship at reduced size): f64/f64 vs the
  default mixed policy.
- ELL (unstructured gather) SpMV rate and a MINC-augmented config.
- cpu_reference: scipy spilu+bicgstab on the same Jacobian (reduced
  size) — the PETSc-proxy wall-time datapoint (BASELINE.md).

Artifact robustness: the headline JSON line is printed IMMEDIATELY
after the headline measurement, and the line is RE-PRINTED (enriched)
after every completed extra section — a reader takes the LAST line of
stdout, so a timeout/kill at any point still yields the freshest
complete record. Every extra section, including its compile, is gated
on BENCH_BUDGET_S (default 1100 s).
"""

import json
import os
import sys
import time

import numpy as np


def _is_oom(e: Exception) -> bool:
    s = f"{type(e).__name__}: {e}"
    return any(
        k in s
        for k in (
            "RESOURCE_EXHAUSTED",
            "Out of memory",
            "out of memory",
            "OOM",
            "Resource exhausted",
        )
    )


def timeit(f, reps=3):
    """Best-of-reps seconds, DEVICE-RESIDENT: block_until_ready waits
    for completion without any device->host transfer. This is the
    production condition — the timestep loop keeps all state on
    device and only scalars (converged flags, iteration counts) ever
    cross to the host."""
    import jax

    jax.block_until_ready(f())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        best = min(best, time.perf_counter() - t0)
    return best


def time_fori(make_chain, k1=5, k2=55):
    """seconds/iteration for a jitted fori_loop chain; slope between
    two chain lengths cancels fixed costs and any host round-trip."""
    import jax

    ts = {}
    for k in (k1, k2):
        f = make_chain(k)
        jax.block_until_ready(f())
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            best = min(best, time.perf_counter() - t0)
        ts[k] = best
    return max((ts[k2] - ts[k1]) / (k2 - k1), 1e-12)


def flagship_config(nx, ny, nz):
    """Waiwera JSON config of the flagship box (mesh given separately):
    eos_wge, atmospheric top boundary, a deliverability producer in
    the top layer and a warm injector in the bottom layer."""
    n = nx * ny * nz
    top0 = n - nx * ny  # first cell of the top layer
    return {
        "eos": {"name": "wge"},
        "initial": {"primary": [5.0e6, 220.0, 1.0e5], "region": 1},
        "rock": {
            "types": [
                {
                    "name": "res",
                    "permeability": [5e-14, 5e-14, 2e-14],
                    "porosity": 0.1,
                }
            ]
        },
        "boundaries": [
            {
                "primary": [1.0e5, 20.0, 1.0e3],
                "region": 1,
                "faces": {
                    "cells": list(range(top0, n)),
                    "normal": [0.0, 0.0, 1.0],
                },
            }
        ],
        "source": [
            {
                "cell": top0 + nx * (ny // 2) + nx // 2,
                "deliverability": {"productivity": 1e-12,
                                   "pressure": 5.0e5},
                "direction": "production",
            },
            {"cell": nx * (ny // 2) + nx // 4, "rate": 20.0,
             "enthalpy": 500.0e3},
        ],
        "time": {"step": {"size": 1.0e5}},
    }


def build_sim(nx, ny, nz, minc=False):
    import jax

    jax.config.update("jax_enable_x64", True)
    from waiwera_tpu.mesh.rect import rectangular_mesh
    from waiwera_tpu.sim.simulation import Simulation

    mesh = rectangular_mesh(
        [50.0] * nx, [50.0] * ny, [20.0] * nz, origin=[0, 0, -20.0 * nz]
    )
    n = nx * ny * nz
    config = flagship_config(nx, ny, nz)
    if minc:
        # dual-porosity lower half (production3d-style MINC config,
        # /root/reference/test/benchmark/minc/production3d)
        config["mesh"] = {
            "zones": {
                "lower": {"type": "box", "z": [-20.0 * nz, -10.0 * nz]}
            },
            "minc": {
                "geometry": {
                    "fracture": {"volume": 0.1, "spacing": 50.0},
                    "matrix": {"volume": [0.3, 0.6]},
                },
                "rock": {"zones": ["lower"]},
            },
        }
    return Simulation(config, mesh=mesh), n


def make_step(sim, pc="bjacobi", linear_dtype="float32",
              jacobian_dtype="float32"):
    from waiwera_tpu.solver.newton import NewtonParams

    params = NewtonParams(
        max_iterations=8,
        min_iterations=1,
        linear_dtype=linear_dtype,
        linear_pc=pc,
        jacobian_dtype=jacobian_dtype,
    )
    return sim.make_step_fn(params, "beuler")


def time_step(sim, step, reps=3, settle=4, dt0=1.0e5):
    """Time one ACCEPTED implicit step at a production operating point.

    Drives the already-jitted step function with the timestepper's
    retry ladder (dt*0.2 on failure, timestepper.F90:1995) to find a
    step size the model accepts, holds that size FIXED for `settle`
    accepted steps (no amplification: this model steepens as the
    thermal front develops, so an amplify/fail cycle never settles),
    then times the NEXT converged step from that state. All warm-up
    calls reuse the one compiled executable.

    Why: the FIRST trial step from the uniform initial state can
    diverge and fail (the production timestepper would retry it at
    dt*0.2), so timing it would measure a failed solve. The timed step
    must be a converged accepted step or time_step raises.
    """
    import jax.numpy as jnp

    lhs, fluid, _ = sim.lhs_at(sim.y0, sim.region0)
    fx = sim.initial_fluxes(sim.y0, sim.region0)
    y, region, temp = sim.y0, sim.region0, fluid.temperature
    lhs2 = lhs
    t = 0.0
    dt = dt0
    dt_last = dt0
    first = 1.0
    accepted = 0
    tries = 0
    max_tries = 15 + 5 * settle

    def call(dt_try):
        return step(
            y, region, temp, lhs, lhs2,
            jnp.asarray(t), jnp.asarray(dt_try), jnp.asarray(dt_last),
            jnp.asarray(first), fluid_last=fluid, fluxes_last=fx,
        )

    while accepted < settle and tries < max_tries:
        tries += 1
        res, f_new, lhs_new, fx_new = call(dt)
        if bool(res.converged) and not bool(res.failed):
            y, region, temp = res.y, res.region, f_new.temperature
            lhs2, lhs = lhs, lhs_new
            fluid, fx = f_new, fx_new
            t += dt
            dt_last = dt
            first = 0.0
            accepted += 1
        else:
            dt *= 0.2
    if accepted < settle:
        raise RuntimeError(
            f"bench settle failed: {accepted}/{settle} accepted "
            f"in {tries} tries"
        )
    res = call(dt)[0]
    if not (bool(res.converged) and not bool(res.failed)):
        # the state can steepen even at fixed dt (front passage):
        # take one rung down the retry ladder for the timed step
        dt *= 0.2
        res = call(dt)[0]
        if not (bool(res.converged) and not bool(res.failed)):
            raise RuntimeError(
                "bench step does not converge at the settled state"
            )

    # pre-stage every argument on device ONCE: per-call jnp.asarray
    # scalars are host->device transfers that the timed region should
    # not include
    targs = (
        y, region, temp, lhs, lhs2,
        jnp.asarray(t), jnp.asarray(dt), jnp.asarray(dt_last),
        jnp.asarray(first),
    )

    def run():
        return step(*targs, fluid_last=fluid, fluxes_last=fx)[0].y

    t_best = timeit(run, reps)
    # operating-point provenance for the caller (bench artifact)
    time_step.last_info = {
        "settle_accepted": accepted,
        "settle_tries": tries,
        "dt_timed": float(dt),
        "sim_time_reached": float(t),
    }
    return t_best, int(res.iterations), int(res.linear_iterations)


def measure_bandwidth(nbytes=512 * 2**20):
    """Device memory bandwidth (bytes/s) of a plain-JAX scale-copy
    chain: each fori_loop iteration reads and writes one f32 array, so
    it moves `nbytes` in all. The loop-carried dependency keeps XLA
    from folding iterations together."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    x0 = jnp.ones((max(int(nbytes) // 8, 1),), jnp.float32)

    def make_chain(k):
        @jax.jit
        def run(x):
            return lax.fori_loop(
                0, k, lambda i, v: v * jnp.float32(0.999999), x
            )[:1]

        return lambda: run(x0)

    per = time_fori(make_chain, 10, 110)
    return 8.0 * x0.size / per


def main():
    import jax
    import jax.numpy as jnp

    from waiwera_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    fast = os.environ.get("BENCH_FAST", "") not in ("", "0")
    t_start = time.time()
    budget = float(os.environ.get("BENCH_BUDGET_S", 1100))

    def over_budget(reserve=0.0):
        """True once the remaining budget is below `reserve` seconds —
        checked BEFORE each extra section so a section's compile never
        starts if it cannot also finish."""
        return time.time() - t_start > budget - reserve

    # flagship size with a fallback ladder so the driver always gets a
    # number even on a memory-constrained device
    sizes = [(128, 64, 64), (64, 64, 32), (32, 32, 16)]
    if "BENCH_NX" in os.environ:
        sizes = [(
            int(os.environ["BENCH_NX"]),
            int(os.environ.get("BENCH_NY", 32)),
            int(os.environ.get("BENCH_NZ", 16)),
        )]

    # bjacobi is the production default: it is exactly
    # partition-invariant under domain decomposition (SCALING.md).
    # dilu/line/cpr remain selectable and are re-measured every run.
    linear_pc = os.environ.get("BENCH_PC", "bjacobi")
    sim = None
    for nx, ny, nz in sizes:
        try:
            sim, n = build_sim(nx, ny, nz)
            step = make_step(sim, pc=linear_pc)
            step_seconds, iterations, linear_its = time_step(sim, step)
            break
        except Exception as e:
            if not _is_oom(e):
                raise
            print(f"# bench size {nx}x{ny}x{nz} OOM: {e!r}", flush=True)
            sim = None
    if sim is None:
        raise SystemExit("no bench size fits the device")

    npv = sim.eos.num_primary_variables
    dof_per_s = n * npv / step_seconds

    # ---- headline exists from here; extras are best-effort -----------
    result = {
        "metric": "implicit_timestep_dof_per_s",
        "value": dof_per_s,
        "unit": "dof/s",
        "cells": n,
        "unknowns": n * npv,
        "eos": "wge",
        "newton_iterations": iterations,
        "linear_iterations": linear_its,
        "linear_pc": linear_pc,
        "step_seconds": step_seconds,
        "operating_point": getattr(time_step, "last_info", None),
    }

    def emit():
        """(Re-)print the full JSON record. The driver takes the LAST
        line, so each completed section freshens the artifact and an
        early kill still leaves a parseable headline."""
        print(json.dumps(result), flush=True)

    # the headline goes to stdout BEFORE any extra work
    emit()

    from waiwera_tpu.solver import krylov
    from waiwera_tpu.solver.system import MethodCoeffs

    system = sim.system
    lhs0, fluid0, _ = sim.lhs_at(sim.y0, sim.region0)
    dt = jnp.asarray(1.0e5)
    coeffs = MethodCoeffs(c_lhs=jnp.asarray(1.0), dt_eff=dt,
                          const=-lhs0)

    # ---- in-step stage breakdown (scalar outputs only) ---------------
    try:
        if over_budget(reserve=180.0):
            raise RuntimeError("skipped: time budget")

        @jax.jit
        def resid_only(y):
            r, L, fx, err = system.residual(
                y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt
            )
            return r[:1, :1]

        t_res = timeit(lambda: resid_only(sim.y0))
        result["residual_f64_seconds"] = t_res

        @jax.jit
        def jac_only(y):
            parts = system.jacobian_parts(
                y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt,
                tangent_dtype=jnp.float32,
            )
            return parts[0][:1, :1]

        t_jac = timeit(lambda: jac_only(sim.y0))
        result["jacobian_parts_seconds"] = t_jac

        @jax.jit
        def lin_only(y):
            r, _, _, err = system.residual(
                y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt
            )
            parts = system.jacobian_parts(
                y, sim.region0, sim.rock, coeffs, jnp.asarray(0.0), dt,
                tangent_dtype=jnp.float32,
            )
            mv, pc = system.linear_operator_from_parts(
                parts, linear_pc, dtype=jnp.float32
            )
            res = krylov.solve("bcgs", mv, r.astype(jnp.float32),
                               precond=pc, rtol=1e-5)
            x0 = res.x.reshape(-1)[0]
            return jnp.stack([x0, res.iterations.astype(jnp.float32)])

        t_rjl = timeit(lambda: lin_only(sim.y0))
        lin_its_one = int(np.asarray(lin_only(sim.y0))[1])
        # the jacobian's f64 PRIMAL chain (linearize) subsumes the
        # residual chain under CSE inside the combined program, so the
        # solve cost is t_rjl - t_jac (subtracting t_res too would
        # under-count it)
        t_lin = max(t_rjl - t_jac, 0.0)
        result["linear_solve_seconds"] = t_lin
        result["linear_solve_iterations_one"] = lin_its_one

        # phase-transition pass (unscale -> transition -> bounds ->
        # scale), the post-linesearch fluid_trans stage
        eos = sim.eos
        temp0 = fluid0.temperature

        @jax.jit
        def trans_only(y):
            old_primary = eos.unscale(y, sim.region0)
            new_primary, new_region, _, terr = eos.transition(
                old_primary, old_primary * 1.000001, sim.region0, temp0
            )
            new_primary, berr = eos.check_primary_variables(
                new_primary, new_region
            )
            return eos.scale(new_primary, new_region)[:1, :1]

        t_trans = timeit(lambda: trans_only(sim.y0))
        result["transition_seconds"] = t_trans

        # carried-state initial residual (rhs_from_fluxes + sources
        # only — the step reuses the previous accepted step's
        # fluid/lhs/fluxes instead of re-running the f64 EOS chain)
        fx0 = sim.initial_fluxes(sim.y0, sim.region0)

        @jax.jit
        def r0_fast(L, fx):
            return system.residual_from_state(
                fluid0, L, fx, coeffs, jnp.asarray(0.0), dt
            )[:1, :1]

        t_r0 = timeit(lambda: r0_fast(lhs0, fx0))
        result["initial_residual_seconds"] = t_r0

        # composable per-iteration body cost: newton with the Krylov
        # inner loop capped at 1 iteration terminates after ONE
        # Newton iteration (the unconverged 1-it solve fails the
        # step), i.e. t = r0 + one full fused body (jacobian + pack/
        # factor + transitions + f64 recompute + reductions). The
        # standalone stage timings above are un-fused upper bounds
        # (XLA fuses across stages inside the loop body), so the
        # self-consistency check composes from THIS measurement.
        from waiwera_tpu.solver.newton import NewtonParams, newton_solve

        cap_params = NewtonParams(
            max_iterations=2, min_iterations=2,
            linear_dtype="float32", linear_pc=linear_pc,
            jacobian_dtype="float32", linear_max_iterations=1,
        )
        fluid0_t = fluid0.temperature

        @jax.jit
        def newton_cap1(y):
            res = newton_solve(
                system, y, sim.region0, fluid0_t, sim.rock, coeffs,
                jnp.asarray(0.0), dt, lhs_scale=lhs0,
                params=cap_params, initial=(fluid0, lhs0, fx0),
            )
            return res.y[:1, :1]

        t_cap1 = timeit(lambda: newton_cap1(sim.y0))
        body_seconds = max(t_cap1 - t_r0, 0.0)
        result["newton_body_seconds"] = body_seconds

        # stage sum per the Newton loop: carried-state initial
        # residual + its * fused body + the Krylov iterations beyond
        # the one already inside each body measurement. Final-iterate
        # fluid/lhs/fluxes are carried out of the loop (no separate
        # output stage).
        its = max(iterations, 1)
        lin_per_it = t_lin / max(lin_its_one, 1)
        stage_sum = (
            t_r0
            + its * body_seconds
            + max(linear_its - its, 0) * lin_per_it
        )
        result["stage_sum_seconds"] = stage_sum
        result["stage_vs_step"] = stage_sum / step_seconds
    except Exception as e:
        result["stage_error"] = repr(e)

    print(f"# headline done: {step_seconds:.2f}s/step", flush=True)
    emit()

    # ---- SpMV roofline ----------------------------------------------
    try:
        if over_budget(reserve=150.0):
            raise RuntimeError("skipped: time budget")
        nnzb = int(system.structure.indices.shape[0])
        nnz = nnzb * npv * npv
        nrows = system.structure.num_rows
        result["spmv_path"] = "ell" if system.dia is None else "jnp-dia"

        def make_chain(k):
            @jax.jit
            def run(y):
                parts = system.jacobian_parts(
                    y, sim.region0, sim.rock, coeffs,
                    jnp.asarray(0.0), dt, tangent_dtype=jnp.float32,
                )
                mv, _ = system.linear_operator_from_parts(
                    parts, "none", dtype=jnp.float32
                )
                x0 = jnp.full((nrows, npv), 1.0, jnp.float32)

                def body(i, x):
                    y2 = mv(x)
                    m = jnp.max(jnp.abs(y2)) + jnp.float32(1e-30)
                    return y2 * (jnp.float32(1.0) / m)

                return jax.lax.fori_loop(0, k, body, x0)[:1, :1]

            return lambda: run(sim.y0)

        per = time_fori(make_chain)

        def make_norm_chain(k):
            @jax.jit
            def run():
                x0 = jnp.full((nrows, npv), 1.0, jnp.float32)

                def body(i, x):
                    m = jnp.max(jnp.abs(x)) + jnp.float32(1e-30)
                    return x * (jnp.float32(1.0) / m)

                return jax.lax.fori_loop(0, k, body, x0)[:1, :1]

            return run

        norm_per = time_fori(make_norm_chain)
        spmv_seconds = max(per - norm_per, 1e-12)
        # sanity: an SpMV faster than 1 us cannot be real on any mesh
        # this bench runs — the chain slope fell below timer noise
        # (only happens at tiny BENCH_NX debug sizes)
        if spmv_seconds < 1e-6:
            raise RuntimeError(
                f"chain slope {spmv_seconds:.2e}s below timer noise; "
                "roofline needs a larger mesh"
            )
        result["spmv_nnz_per_s"] = nnz / spmv_seconds
        # bytes at speed of light: band data + one x read + one y write
        spmv_bytes = 4.0 * (nnz + 2 * nrows * npv)
        bw = measure_bandwidth()
        result["spmv_roofline_fraction"] = (
            (spmv_bytes / spmv_seconds) / bw if bw else 0.0
        )
        result["measured_bandwidth_gb_s"] = bw / 1e9
        print("# roofline done", flush=True)
    except Exception as e:
        result["spmv_error"] = repr(e)
    emit()

    # ---- reduced-size extras: PC/dtype comparisons, ELL, MINC, CPU --
    rx, ry, rz = (48, 32, 32) if n >= 48 * 32 * 32 else (nx, ny, nz)
    if over_budget(reserve=120.0):
        fast = True
        result["extras_skipped"] = "time budget"
        emit()
    if not fast:
        sim_r = None
        try:
            sim_r, n_r = build_sim(rx, ry, rz)
            t_mixed, it_m, li_m = time_step(
                sim_r, make_step(sim_r, pc=linear_pc), reps=2
            )
            result["reduced_cells"] = n_r
            result["reduced_step_seconds"] = t_mixed
            result["reduced_linear_iterations"] = li_m
            result["pc_sweep"] = {
                linear_pc: {"step_seconds": t_mixed, "newton": it_m,
                            "linear_iterations": li_m}
            }
            emit()
            if over_budget(reserve=90.0):
                raise RuntimeError("skipped: time budget")
            t_f64, it_6, li_6 = time_step(
                sim_r,
                make_step(sim_r, pc=linear_pc, linear_dtype="float64",
                          jacobian_dtype="float64"),
                reps=2,
            )
            result["dtype_table"] = {
                "cells": n_r,
                "mixed_f32_step_seconds": t_mixed,
                "full_f64_step_seconds": t_f64,
                "f64_over_mixed": t_f64 / t_mixed,
            }
            print("# dtype table done", flush=True)
        except Exception as e:
            result["dtype_error"] = repr(e)
        emit()

        # ELL path: permute cells so the DIA detection fails
        try:
            if sim_r is None:
                raise RuntimeError("skipped: no reduced sim")
            if over_budget(reserve=90.0):
                raise RuntimeError("skipped: time budget")
            from waiwera_tpu.solver import bsr as bsr_mod
            from waiwera_tpu.ops import ell as ops_ell

            rng = np.random.default_rng(0)
            n_e = rx * ry * rz
            perm = rng.permutation(n_e)
            fc_all = np.asarray(sim_r.mesh.face_cells)
            inner = (fc_all < n_e).all(axis=1)
            fc = perm[fc_all[inner]]
            st = bsr_mod.build_structure(n_e, fc, npv)
            es = ops_ell.ell_structure(st)
            nnzb_e = int(st.indices.shape[0])
            data = jnp.asarray(
                rng.standard_normal((nnzb_e, npv, npv)),
                jnp.float32,
            )
            mat = bsr_mod.BSRMatrix(structure=st, data=data)

            def make_echain(k):
                @jax.jit
                def run(d):
                    m = ops_ell.to_ell(
                        bsr_mod.BSRMatrix(structure=st, data=d), es,
                        jnp.float32,
                    )
                    x0 = jnp.full((n_e, npv), 1.0, jnp.float32)

                    def body(i, x):
                        y2 = m.matvec(x)
                        mx = jnp.max(jnp.abs(y2)) + jnp.float32(1e-30)
                        return y2 * (jnp.float32(1.0) / mx)

                    return jax.lax.fori_loop(0, k, body, x0)[:1, :1]

                return lambda: run(data)

            per_e = time_fori(make_echain, 3, 13)
            result["ell_spmv_nnz_per_s"] = nnzb_e * npv * npv / per_e
            print("# ell done", flush=True)
        except Exception as e:
            result["ell_error"] = repr(e)
        emit()

        # MINC-augmented step (dual-porosity production config)
        try:
            if over_budget(reserve=120.0):
                raise RuntimeError("skipped: time budget")
            sim_m, _ = build_sim(rx, ry, rz, minc=True)
            t_minc, it_mm, li_mm = time_step(
                sim_m, make_step(sim_m, pc=linear_pc), reps=2
            )
            result["minc_cells"] = int(sim_m.mesh.num_cells)
            result["minc_step_seconds"] = t_minc
            result["minc_dof_per_s"] = (
                sim_m.mesh.num_cells * npv / t_minc
            )
            sys_m = sim_m.system
            result["minc_spmv_path"] = (
                "dia"
                if sys_m.dia is not None
                else (
                    "hybrid-dia"
                    if getattr(sys_m, "hybrid", None) is not None
                    else "ell"
                )
            )
            print("# minc done", flush=True)
        except Exception as e:
            result["minc_error"] = repr(e)
        emit()

        # CPU reference: scipy spilu + bicgstab on the same Jacobian
        try:
            if sim_r is None:
                raise RuntimeError("skipped: no reduced sim")
            if over_budget(reserve=120.0):
                raise RuntimeError("skipped: time budget")
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            lhs_r, _, _ = sim_r.lhs_at(sim_r.y0, sim_r.region0)
            coeffs_r = MethodCoeffs(
                c_lhs=jnp.asarray(1.0), dt_eff=dt, const=-lhs_r
            )
            r_r, _, _, _, mat_r = sim_r.system.residual_and_jacobian(
                sim_r.y0, sim_r.region0, sim_r.rock, coeffs_r,
                jnp.asarray(0.0), dt,
            )
            st = mat_r.structure
            A = sp.bsr_matrix(
                (
                    np.asarray(mat_r.data),
                    np.asarray(st.indices),
                    np.asarray(st.indptr),
                ),
                shape=(st.num_rows * npv, st.num_rows * npv),
            ).tocsc()
            b = -np.asarray(r_r).reshape(-1)
            t0 = time.perf_counter()
            what = "scipy spilu+bicgstab linear solve"
            try:
                ilu = spla.spilu(A, drop_tol=1e-5, fill_factor=10)
                M = spla.LinearOperator(A.shape, ilu.solve)
            except Exception:
                # ILU pivot breakdown: fall back to block-Jacobi (the
                # same preconditioner the device solve uses)
                what = "scipy bjacobi+bicgstab linear solve"
                dinv = np.linalg.inv(
                    np.asarray(mat_r.data)[
                        np.asarray(mat_r.structure.diag_pos)
                    ]
                )

                def bj(v):
                    return np.einsum(
                        "nij,nj->ni", dinv, v.reshape(-1, npv)
                    ).reshape(-1)

                M = spla.LinearOperator(A.shape, bj)
            cnt = {"n": 0}

            def cb(xk):
                cnt["n"] += 1

            x, info = spla.bicgstab(
                A, b, M=M, rtol=1e-5, maxiter=2000, callback=cb
            )
            t_cpu = time.perf_counter() - t0
            result["cpu_reference"] = {
                "cells": n_r,
                "what": what,
                "seconds": t_cpu,
                "iterations": cnt["n"],
                "info": int(info),
            }
            if "linear_solve_seconds" in result:
                # scale our flagship linear-solve to the reduced size
                scale = n_r / n
                result["cpu_reference"]["device_linear_seconds_scaled"] = (
                    result["linear_solve_seconds"] * scale
                )
        except Exception as e:
            result["cpu_reference_error"] = repr(e)
        emit()

        # preconditioner sweep (the data behind the bjacobi default):
        # remaining candidates on the same reduced system — dilu (the
        # reference's ASM/ILU(0) analogue), z-line block-tridiagonal,
        # CPR pressure-MG. Last section: each candidate costs a fresh
        # compile, so it only consumes leftover budget.
        for other in ("dilu", "line", "cpr"):
            if other == linear_pc or sim_r is None:
                continue
            if over_budget(reserve=300.0):
                result["pc_sweep_truncated"] = "time budget"
                break
            try:
                t2, it2, li2 = time_step(
                    sim_r, make_step(sim_r, pc=other), reps=2
                )
                result.setdefault("pc_sweep", {})[other] = {
                    "step_seconds": t2, "newton": it2,
                    "linear_iterations": li2,
                }
                print(f"# pc {other}: {t2:.2f}s ({it2} newton, "
                      f"{li2} its)", flush=True)
            except Exception as e:
                result.setdefault("pc_sweep", {})[other] = {
                    "error": repr(e)
                }
            emit()

    result["bench_wall_seconds"] = time.time() - t_start
    emit()


if __name__ == "__main__":
    # deterministic tracing -> deterministic HLO -> persistent-cache
    # HITS across processes: with a random hash seed each run may
    # trace set-ordered code to a slightly different program and
    # recompile the flagship step from scratch
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable] + sys.argv)
    main()
