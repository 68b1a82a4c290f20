"""Adaptive implicit timestepper.

Host-level state machine reproducing timestepper.F90: backward Euler /
BDF2 / direct steady state methods, fixed step-size sequences with
fall-over to adaptive stepping, iteration/change step-size monitors,
the retry ladder (dt x reduction on nonconvergence, up to max tries),
checkpoints at exact output times, and stop criteria. Each timestep try
is a single jitted device program (Newton + Krylov + transitions).
"""

from __future__ import annotations

import time as _walltime
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from waiwera_tpu.solver.newton import NewtonParams
from waiwera_tpu.utils.logging import Logger

# timestep statuses (timestepper.F90:33-44)
OK = "OK"
NOT_CONVERGED = "not converged"
TOO_SMALL = "increase"
TOO_BIG = "reduce"
ABORTED = "aborted"
FINAL = "final"
RESTORE = "restore"


@dataclass
class Checkpoints:
    """Exact output times (timestepper_checkpoints_type,
    timestepper.F90:95-113,863-968)."""

    times: Optional[np.ndarray] = None
    repeat: int = 1
    tolerance: float = 0.1
    start_time: float = 0.0
    index: int = 0
    repeat_index: int = 1
    repeat_shift: float = 0.0
    done: bool = True
    hit: bool = False
    next_time: float = 0.0
    restore_stepsize: float = 0.0

    def init(self):
        if self.times is None or len(self.times) == 0:
            self.done = True
            return
        self.done = False
        self.tolerance = max(self.tolerance, 1e-6)
        self.repeat_shift = self.times[-1]
        if self.repeat_shift > self.start_time:
            self.repeat_shift -= self.start_time
        self.index = 0
        self.repeat_index = 1
        self.next_time = self.times[0]
        while self.next_time < self.start_time and not self.done:
            self.update()
        self.hit = False

    def check(self, t_end: float, dt: float):
        if self.done:
            self.hit = False
        elif t_end + self.tolerance * dt >= self.next_time:
            self.hit = True
            self.restore_stepsize = dt
        else:
            self.hit = False

    def update(self):
        if not self.done:
            self.index += 1
            if self.index >= len(self.times):
                if 0 < self.repeat <= self.repeat_index:
                    self.done = True
                else:
                    self.repeat_index += 1
                    self.index = 0
            if not self.done:
                self.next_time = (
                    self.times[self.index]
                    + (self.repeat_index - 1) * self.repeat_shift
                )
        self.hit = False


class Timestepper:
    def __init__(self, config: dict, sim, output=None, logger=None):
        self.sim = sim
        self.output = output
        self.log = logger or Logger()
        tcfg = (config.get("time") or {})
        scfg = (tcfg.get("step") or {})

        self.method = str(scfg.get("method", "beuler")).lower()
        self.steady_state = self.method == "directss"

        # stop criteria
        self.stop_time = tcfg.get("stop", None)
        self.start_time = float(tcfg.get("start", 0.0))
        maximum = scfg.get("maximum", {}) or {}
        self.max_steps = maximum.get("number", 100)
        if self.max_steps is None:
            self.max_steps = -1
        self.max_stepsize = float(maximum.get("size", 0.0) or 0.0)
        self.max_tries = int(maximum.get("tries", 10))
        stop_cfg = (scfg.get("stop", {}) or {}).get("size", {}) or {}
        self.stop_min_stepsize = stop_cfg.get("minimum", -1.0) or -1.0
        self.stop_max_stepsize = stop_cfg.get("maximum", -1.0) or -1.0

        # step sizes
        size = scfg.get("size", 0.1)
        if isinstance(size, (list, tuple, np.ndarray)):
            self.sizes = [float(s) for s in size]
        else:
            self.sizes = [float(size)]

        # adaptor (timestepper.F90:77-93)
        acfg = scfg.get("adapt", {}) or {}
        self.adapt_on_input = bool(acfg.get("on", False))
        self.adapt_method = str(acfg.get("method", "iteration")).lower()
        self.adapt_min = float(acfg.get("minimum", 5.0))
        self.adapt_max = float(acfg.get("maximum", 8.0))
        self.adapt_reduction = float(acfg.get("reduction", 0.2))
        self.adapt_amplification = float(acfg.get("amplification", 2.0))

        # nonlinear solver params
        sol = (scfg.get("solver", {}) or {}).get("nonlinear", {}) or {}
        tol = sol.get("tolerance", {}) or {}
        ftol = tol.get("function", {}) or {}
        utol = tol.get("update", {}) or {}
        lin = (scfg.get("solver", {}) or {}).get("linear", {}) or {}
        def opt(d, key, default):
            v = d.get(key, default)
            return default if v is None else v

        self.newton_params = NewtonParams(
            max_iterations=int(
                opt(sol.get("maximum", {}) or {}, "iterations", 8)
            ),
            min_iterations=int(
                opt(sol.get("minimum", {}) or {}, "iterations", 0)
            ),
            function_rtol=float(opt(ftol, "relative", 1e-5)),
            function_atol=float(opt(ftol, "absolute", 1.0)),
            update_rtol=float(opt(utol, "relative", 1e-10)),
            update_atol=float(opt(utol, "absolute", 1.0)),
            linear_method=str(opt(lin, "type", "bcgs")).lower(),
            # default bjacobi, diverging from the reference's
            # ASM/ILU(0) (timestepper.F90:2019-2022): it is exact
            # block-Jacobi under any domain decomposition, so Krylov
            # counts do not depend on the device count. The choice has
            # not been measured on the GPU yet. "asm"/"ilu"/"line"/
            # "cpr" still select those paths when configured
            # explicitly.
            linear_pc=str(
                opt(lin.get("preconditioner", {}) or {}, "type", "bjacobi")
            ).lower(),
            # linear tolerances / subspace options (reference JSON:
            # time.step.solver.linear.tolerance.relative,
            # .maximum.iterations, .options.gmres.restart —
            # timestepper.F90:1677-1700,1769-1789)
            linear_rtol=float(
                opt(lin.get("tolerance", {}) or {}, "relative", 1e-5)
            ),
            linear_max_iterations=int(
                opt(lin.get("maximum", {}) or {}, "iterations", 1000)
            ),
            linear_restart=int(
                opt(
                    (lin.get("options", {}) or {}).get("gmres", {}) or {},
                    "restart",
                    30,
                )
            ),
            # extension over the reference: precision of the inner
            # Krylov solve (f32 halves the bytes it streams; the Newton
            # loop stays f64)
            linear_dtype=str(opt(lin, "dtype", "float64")).lower(),
            jacobian_dtype=str(
                opt(lin, "jacobian_dtype", "float64")
            ).lower(),
            # per-iteration monitor (-snes_monitor analogue)
            monitor=bool(opt(sol, "monitor", False)),
        )

        # output config
        ocfg = config.get("output", {}) or {}
        self.output_initial = bool(ocfg.get("initial", True))
        self.output_final = bool(ocfg.get("final", True))
        self.output_frequency = int(ocfg.get("frequency", 1))
        # Jacobian dump for debugging (output.jacobian: true or
        # {"filename": ...}; flow_simulation.F90:309-390 MatView
        # analogue — written at every output time, npz BSR instead of
        # PETSc binary)
        jac_cfg = ocfg.get("jacobian", False)
        self.jacobian_filename = None
        if jac_cfg:
            if isinstance(jac_cfg, dict):
                self.jacobian_filename = jac_cfg.get("filename")
            if not self.jacobian_filename:
                base = getattr(output, "filename", None) or config.get(
                    "title", "waiwera"
                )
                stem = str(base)
                if stem.endswith(".h5"):
                    stem = stem[:-3]
                self.jacobian_filename = stem + "_jacobian.npz"

        # checkpoints
        self.checkpoints = Checkpoints(start_time=self.start_time)
        ccfg = ocfg.get("checkpoint")
        if ccfg:
            rep = ccfg.get("repeat", 1)
            if isinstance(rep, bool):
                rep = -1 if rep else 1
            times = ccfg.get("time")
            if times is None and "step" in ccfg:
                steps = np.asarray(ccfg["step"], dtype=np.float64)
                times = self.start_time + np.cumsum(steps)
            self.checkpoints = Checkpoints(
                times=np.asarray(times, dtype=np.float64),
                repeat=int(rep),
                tolerance=float(ccfg.get("tolerance", 0.1)),
                start_time=self.start_time,
            )
        self.checkpoints.init()

        if self.steady_state:
            self.sizes = [0.0]
            self.max_steps = 1
            self.max_tries = 1
            self.adapt_on_input = False

        self.step_fn = sim.make_step_fn(self.newton_params, self.method)
        self.tracer_step_fn = (
            sim.make_tracer_step_fn()
            if sim.tracers is not None and not self.steady_state
            else None
        )

        # runtime state
        self.taken = 0
        self.output_index = 0

    # ------------------------------------------------------------------

    def _monitor(self, num_iterations, lhs_new, lhs_last):
        """Adaptor monitor (timestepper.F90:277-310). The change
        monitor reduces on device and transfers one scalar (the old
        numpy version pulled both full LHS arrays to host every
        accepted step)."""
        if self.adapt_method == "iteration":
            return float(num_iterations)
        if not hasattr(self, "_change_eta"):
            import jax

            @jax.jit
            def eta(new, last):
                eps = 1e-3
                return jnp.max(
                    jnp.abs(new - last)
                    / jnp.maximum(jnp.abs(last), eps)
                )

            self._change_eta = eta
        return float(self._change_eta(lhs_new, lhs_last))

    def run(self, max_wall_seconds: Optional[float] = None):
        sim = self.sim
        log = self.log

        # state: last accepted step
        t = self.start_time
        y = sim.y0
        region = sim.region0
        lhs, fluid, err = sim.lhs_at(y, region)
        if bool(jnp.any(err & ~sim.mesh_dev.is_ghost)):
            raise RuntimeError(
                "initial fluid property evaluation failed (EOS out of "
                "range in some cells)"
            )
        temperature = fluid.temperature
        lhs_last2 = lhs
        # carried face fluxes at the last accepted state: with them
        # (plus lhs/fluid) the step function skips the initial f64 EOS
        # chain of every Newton solve (newton_solve initial=). Sims
        # without initial_fluxes (test doubles) take the classic path.
        fluxes_carr = (
            sim.initial_fluxes(y, region)
            if hasattr(sim, "initial_fluxes")
            else None
        )
        dt_last = self.sizes[0] if self.sizes[0] > 0 else 1.0
        if self.tracer_step_fn is not None:
            aux_x, aux_al = sim.initial_tracer_state()
            aux_x2, aux_al2 = aux_x, aux_al
        else:
            aux_x = None

        self.taken = 0
        self.output_index = 0
        since_output = 0
        # simulation statistics (flow_simulation.F90:712-741): DOF
        # distribution + Kumar imbalance, source network counts
        stats = getattr(sim, "dof_statistics", None)
        if stats is not None:
            log.write("info", "simulation", "dof", **stats())
        net = sim.sources
        if net is not None and net.num_sources:
            log.write("info", "simulation", "source",
                      count=net.num_sources)
            if getattr(net, "groups", None):
                log.write("info", "simulation", "network.group",
                          count=len(net.groups))
            if getattr(net, "reinjectors", None):
                log.write("info", "simulation", "network.reinject",
                          count=len(net.reinjectors))
        log.write("info", "timestepper", "start", time=t)
        wall0 = _walltime.time()

        flux_nat = None
        flux_out = self.output is not None and (
            getattr(self.output, "face_group", None) is not None
        )
        if self.output_initial and self.output is not None:
            if flux_out:
                flux_nat = np.asarray(self.sim.fluxes_at(y, region))
            fg, xg = self._out_state(fluid, aux_x)
            self.output.write(self.output_index, t, fg,
                              self._source_output(fg, t, dt_last, xg),
                              tracer=xg, fluxes=flux_nat)
            self.output_index += 1

        # fixed-size sequence state (timestepper.F90:1381-1453)
        fixed_index = 0
        adaptor_on = False
        fixed = not self.adapt_on_input
        next_stepsize = self.sizes[0]
        finished = False

        aborted = False
        while not finished:
            # one timestep with retry ladder (timestepper_step :2316)
            accepted = False
            num_tries = 0
            status = OK
            while not (accepted or finished):
                dt = next_stepsize
                t_try = t + dt
                hit_this_try = False

                # checkpoints (:1282-1301)
                if not self.steady_state:
                    self.checkpoints.check(t_try, dt)
                    if self.checkpoints.hit:
                        dt = self.checkpoints.next_time - t
                        t_try = self.checkpoints.next_time
                        hit_this_try = True

                # check_finished (:1233-1274)
                if self.steady_state:
                    finished = self.taken == 1
                else:
                    if (
                        self.stop_time is not None
                        and t_try + self._termination_tol() * dt > self.stop_time
                    ):
                        dt = self.stop_time - t
                        t_try = self.stop_time
                        finished = True
                    elif (
                        self.stop_min_stepsize > 0
                        and dt <= self.stop_min_stepsize
                    ):
                        finished = True
                    elif (
                        self.stop_max_stepsize > 0
                        and dt >= self.stop_max_stepsize
                    ):
                        finished = True
                    if 0 <= self.max_steps <= self.taken + 1:
                        finished = True

                step_args = (
                    y,
                    region,
                    temperature,
                    lhs,
                    lhs_last2,
                    jnp.asarray(t),
                    jnp.asarray(dt),
                    jnp.asarray(dt_last),
                    jnp.asarray(1.0 if self.taken == 0 else 0.0),
                )
                step_kwargs = {}
                if getattr(self.sim, "rock_controls", None):
                    # pre-try-timestep rock controls at the try's end
                    # time (flow_simulation.F90:2040-2094); carried
                    # state was computed under the previous rock, so
                    # the fast initial residual is skipped
                    step_args = step_args + (self.sim.rock_for(t_try),)
                elif fluxes_carr is not None:
                    step_kwargs = dict(
                        fluid_last=fluid, fluxes_last=fluxes_carr
                    )
                res, new_fluid, lhs_new, fluxes = self.step_fn(
                    *step_args, **step_kwargs
                )
                num_tries += 1
                converged = bool(res.converged) and not bool(res.failed)
                its = int(res.iterations)
                tres = None
                if converged and self.tracer_step_fn is not None:
                    # auxiliary (tracer) linear solve for this try
                    # (timestepper.F90:2347-2356); failure retries the
                    # step like a nonlinear failure
                    tres = self.tracer_step_fn(
                        new_fluid,
                        fluxes,
                        aux_x,
                        aux_al,
                        aux_x2,
                        aux_al2,
                        jnp.asarray(t),
                        jnp.asarray(t_try),
                        jnp.asarray(dt),
                        jnp.asarray(dt_last),
                        jnp.asarray(1.0 if self.taken == 0 else 0.0),
                        jnp.asarray(self.method == "bdf2"),
                    )
                    if not bool(tres.converged):
                        log.write("warn", "tracer_solver", "not_converged",
                                  iterations=int(tres.iterations))
                        converged = False
                log.write(
                    "info" if converged else "warn",
                    "nonlinear_solver",
                    "end",
                    converged=converged,
                    iterations=its,
                    linear_iterations=int(res.linear_iterations),
                    max_residual=float(res.max_residual),
                    # worst-residual location in natural cell order
                    # (SNES_monitor parity, timestepper.F90:1855-1894)
                    worst_cell=int(res.worst_cell),
                    worst_equation=int(res.worst_equation),
                )

                # set_current_status (:1305-1376)
                if self.steady_state:
                    status = FINAL if converged else ABORTED
                    finished = True
                    accepted = converged
                    if not converged:
                        aborted = True
                    break
                if converged:
                    if finished and status != ABORTED:
                        status = FINAL
                    elif hit_this_try:
                        status = RESTORE
                    else:
                        eta = self._monitor(its, lhs_new, lhs)
                        adapt_active = adaptor_on or (
                            fixed_index == len(self.sizes) - 1 and not fixed
                        )
                        if adapt_active:
                            if eta < self.adapt_min:
                                status = TOO_SMALL
                            elif eta > self.adapt_max:
                                status = TOO_BIG
                            else:
                                status = OK
                        else:
                            status = OK
                else:
                    if num_tries >= self.max_tries:
                        status = ABORTED
                        finished = True
                        aborted = True
                    else:
                        status = NOT_CONVERGED
                        finished = False
                    self.checkpoints.hit = False

                # set_next_stepsize (:1414-1453)
                if not self.steady_state and status != ABORTED:
                    accepted, next_stepsize, adaptor_on, fixed_index = (
                        self._next_stepsize(
                            status, dt, adaptor_on, fixed, fixed_index,
                            hit_this_try,
                        )
                    )
                elif status == ABORTED:
                    accepted = False
                if not accepted and status in (
                    NOT_CONVERGED,
                    TOO_BIG,
                ):
                    log.write(
                        "warn",
                        "timestep",
                        "reduction",
                        new_size=next_stepsize,
                    )
                if status == ABORTED:
                    log.write("warn", "timestep", "aborted",
                              num_tries=num_tries)
                    break

            if aborted and not accepted:
                break

            # commit step (timestepper_step :2365-2376)
            if accepted:
                self.taken += 1
                dt_last = float(t_try - t)
                t = float(t_try)
                y = res.y
                region = res.region
                lhs_last2 = lhs
                lhs = lhs_new
                fluid = new_fluid
                if fluxes_carr is not None:
                    fluxes_carr = fluxes
                temperature = new_fluid.temperature
                if tres is not None:
                    aux_x2, aux_al2 = aux_x, aux_al
                    aux_x, aux_al = tres.x, tres.al
                if flux_out:
                    f2g = getattr(self.sim, "flux_to_global", None)
                    flux_nat = np.asarray(
                        f2g(fluxes) if f2g is not None else fluxes
                    )
                since_output += 1
                log.write(
                    "info",
                    "timestep",
                    "end",
                    tries=num_tries,
                    size=dt_last,
                    time=t,
                    status=status,
                )
                if self.output is not None and (
                    self.checkpoints.hit
                    or since_output == self.output_frequency
                ):
                    fg, xg = self._out_state(fluid, aux_x)
                    self.output.write(
                        self.output_index, t, fg,
                        self._source_output(fg, t - dt_last, dt_last, xg),
                        tracer=xg, fluxes=flux_nat)
                    self.output_index += 1
                    self._dump_jacobian(y, region, lhs, t, dt_last)
                    if since_output == self.output_frequency:
                        since_output = 0
                if self.checkpoints.hit:
                    # advance past the hit checkpoint whether or not an
                    # output file is attached: a stale hit flag would
                    # clip every subsequent try to dt = 0
                    self.checkpoints.update()
                if status == FINAL:
                    finished = True

            if max_wall_seconds is not None and (
                _walltime.time() - wall0 > max_wall_seconds
            ):
                log.write("warn", "timestepper", "wall_time_limit")
                break

        if (
            self.output is not None
            and self.output_final
            and since_output > 0
        ):
            fg, xg = self._out_state(fluid, aux_x)
            self.output.write(self.output_index, t, fg,
                              self._source_output(fg, t, dt_last, xg),
                              tracer=xg, fluxes=flux_nat)
            self.output_index += 1
            self._dump_jacobian(y, region, lhs, t, dt_last)
        log.write(
            "info",
            "timestepper",
            "end",
            time=t,
            steps=self.taken,
            elapsed_seconds=_walltime.time() - wall0,
        )
        self.final_time = t
        self.final_y = y
        self.final_region = region
        self.final_fluid = fluid
        self.aborted = aborted
        return not aborted

    def _dump_jacobian(self, y, region, lhs, t, dt):
        """Binary Jacobian dump for debugging (output.jacobian;
        flow_simulation.F90:2989 MatView analogue). Written as an npz
        of the BSR arrays at the current solution, in natural cell
        order; load with numpy/scipy (sp.bsr_matrix((data, indices,
        indptr))).

        Note: the dump is always the BACKWARD-EULER Jacobian at the
        final (y, dt) — under BDF2/directss it is a diagnostic
        re-linearisation, not the exact matrix the solver last used
        (the BDF2 history weights differ by O(1) on the LHS term)."""
        if self.jacobian_filename is None or dt <= 0.0:
            return
        from waiwera_tpu.solver.system import method_coeffs

        sim = self.sim
        base = getattr(sim, "base", sim)
        if hasattr(sim, "to_global"):
            y = jnp.asarray(sim.to_global(y))
            region = jnp.asarray(sim.to_global(region))
            lhs = jnp.asarray(sim.to_global(lhs))
        coeffs = method_coeffs(
            "beuler", jnp.asarray(dt), jnp.asarray(dt),
            jnp.asarray(0.0), lhs, lhs,
        )
        _, _, _, _, mat = base.system.residual_and_jacobian(
            y, region, base.rock, coeffs,
            jnp.asarray(t - dt), jnp.asarray(t),
        )
        st = mat.structure
        np.savez(
            self.jacobian_filename,
            data=np.asarray(mat.data),
            indices=np.asarray(st.indices),
            indptr=np.asarray(st.indptr),
            num_rows=st.num_rows,
            block_size=st.block_size,
            time=t,
        )

    def _termination_tol(self):
        return 1e-10

    def _next_stepsize(self, status, dt, adaptor_on, fixed, fixed_index,
                       checkpoint_hit):
        """set_next_stepsize + get_next_fixed_stepsize + adapt
        (timestepper.F90:1381-1475)."""

        def adapt(status, dt):
            if status == TOO_SMALL:
                ns = dt * self.adapt_amplification
                if self.max_stepsize > 0:
                    ns = min(ns, self.max_stepsize)
                return True, ns
            if status in (TOO_BIG, NOT_CONVERGED):
                return False, dt * self.adapt_reduction
            return True, dt

        if adaptor_on:
            if checkpoint_hit and status == RESTORE:
                accepted = True
                next_stepsize = self.checkpoints.restore_stepsize
            else:
                accepted, next_stepsize = adapt(status, dt)
            # switch back to fixed stepping if we reach the fixed sizes
            if fixed_index < len(self.sizes) - 1 or (
                fixed_index >= len(self.sizes) - 1 and fixed
            ):
                if next_stepsize >= self.sizes[fixed_index]:
                    adaptor_on = False
                    next_stepsize = self.sizes[fixed_index]
            return accepted, next_stepsize, adaptor_on, fixed_index

        if status in (TOO_BIG, NOT_CONVERGED):
            adaptor_on = True
            accepted, next_stepsize = adapt(status, dt)
            return accepted, next_stepsize, adaptor_on, fixed_index

        # fixed stepping: advance through the size list
        accepted = True
        fixed_index += 1
        if fixed_index < len(self.sizes):
            next_stepsize = self.sizes[fixed_index]
        else:
            fixed_index = len(self.sizes) - 1
            if fixed:
                next_stepsize = self.sizes[fixed_index]
            else:
                adaptor_on = True
                if checkpoint_hit and status == RESTORE:
                    next_stepsize = self.checkpoints.restore_stepsize
                else:
                    accepted, next_stepsize = adapt(status, dt)
        return accepted, next_stepsize, adaptor_on, fixed_index

    def _out_state(self, fluid, aux_x):
        """Convert step state to natural-order global arrays for output
        (identity single-device; AO restore via
        DistributedSimulation.to_global in multi-device runs)."""
        tg = getattr(self.sim, "to_global", None)
        if tg is None:
            return fluid, aux_x
        import jax.tree_util as jtu

        asj = lambda t: jtu.tree_map(jnp.asarray, t)
        fg = asj(tg(fluid))
        return fg, (None if aux_x is None else asj(tg(aux_x)))

    def _source_field_config(self):
        """Requested output field lists with reference defaults
        (setup_output.rst; hdf5io datasets named <vec>_<field>)."""
        cfg = (self.sim.config.get("output", {}) or {}).get(
            "fields", {}
        ) or {}
        aslist = lambda v: [v] if isinstance(v, str) else list(v or [])
        return {
            "source": aslist(
                cfg.get(
                    "source",
                    ["natural_cell_index", "component", "rate",
                     "enthalpy"],
                )
            ),
            "network_group": aslist(
                cfg.get(
                    "network_group",
                    ["rate", "enthalpy", "water_rate", "steam_rate"],
                )
            ),
            "network_reinject": aslist(
                cfg.get(
                    "network_reinject",
                    ["overflow_water_rate", "overflow_steam_rate"],
                )
            ),
        }

    def _source_output(self, fluid, t0, dt, aux_x=None):
        """Per-source / group / reinjector output fields
        (flow_simulation.F90:2966-2981: source, network_group and
        network_reinject vectors viewed into /source_fields)."""
        if self.sim.sources is None:
            return None
        from waiwera_tpu.sim.sources import source_flows

        net = self.sim.sources
        fields = self._source_field_config()
        collect = {}
        rate, enthalpy = net.flows(fluid, t0, t0 + dt, collect=collect)
        qw, hw, qs, hs = collect.get(
            "separated", (None, None, None, None)
        )
        eos = self.sim.eos
        out = {}
        src_f = fields["source"]
        if "rate" in src_f:
            out["source_rate"] = np.asarray(rate)
        if "enthalpy" in src_f:
            out["source_enthalpy"] = np.asarray(enthalpy)
        if qw is not None:
            qw, hw, qs, hs = (np.asarray(a) for a in (qw, hw, qs, hs))
            tot = np.abs(qw) + np.abs(qs)
            sf = np.where(tot > 0.0, np.abs(qs) / np.where(tot > 0, tot, 1.0), 0.0)
            for nm, v in (
                ("water_rate", qw), ("water_enthalpy", hw),
                ("steam_rate", qs), ("steam_enthalpy", hs),
                ("steam_fraction", sf),
            ):
                if nm in src_f:
                    out["source_" + nm] = v
        comp_wanted = [
            c for c in list(eos.component_names) + ["heat"]
            if f"{c}_flow" in src_f
        ]
        if comp_wanted:
            flow = np.asarray(source_flows(
                fluid, net.arrays, rate, enthalpy,
                eos.num_primary_variables, eos.num_components,
                eos.isothermal,
            ))
            names = list(eos.component_names)
            if not eos.isothermal:
                names.append("heat")
            for k, c in enumerate(names):
                if f"{c}_flow" in src_f:
                    out[f"source_{c}_flow"] = flow[:, k]
        if aux_x is not None and self.sim.tracers is not None:
            # tracer flows at sources (flow_simulation.F90
            # source_update_tracer_flow): production carries the cell
            # tracer mass fraction by the tracer phase flow fraction;
            # injection uses the specified injection rate
            tr = self.sim.tracers
            cells = np.asarray(net.arrays.cell)
            frac = np.asarray(fluid.phase_flow_fractions())[cells][
                :, tr.phase_index
            ]
            xc = np.asarray(aux_x)[cells]
            q = np.asarray(rate)[:, None]
            inj = np.asarray(net.tracer_injection(t0, t0 + dt))
            out["source_tracer_flow"] = np.where(
                q < 0, xc * frac * q, inj
            )
        # source network group / reinjector node fields
        groups = collect.get("group", {})
        if groups and getattr(net, "groups", None):
            gf = fields["network_group"]
            per = {nm: [] for nm in gf}
            for g in net.groups:
                nf = groups[g.name]
                tot = abs(float(nf.qw)) + abs(float(nf.qs))
                vals = {
                    "rate": nf.q, "enthalpy": nf.h,
                    "water_rate": nf.qw, "water_enthalpy": nf.hw,
                    "steam_rate": nf.qs, "steam_enthalpy": nf.hs,
                    "steam_fraction": (
                        abs(float(nf.qs)) / tot if tot > 0 else 0.0
                    ),
                }
                for nm in gf:
                    if nm in vals:
                        per[nm].append(float(vals[nm]))
            for nm, v in per.items():
                if v:
                    out["network_group_" + nm] = np.asarray(v)
        rein = collect.get("reinject", {})
        if rein and getattr(net, "reinjectors", None):
            rf = fields["network_reinject"]
            per = {nm: [] for nm in rf}
            for r in net.reinjectors:
                vals = rein.get(r.name, {})
                for nm in rf:
                    if nm in vals:
                        per[nm].append(float(vals[nm]))
            for nm, v in per.items():
                if v:
                    out["network_reinject_" + nm] = np.asarray(v)
        return out
