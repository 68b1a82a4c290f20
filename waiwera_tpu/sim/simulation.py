"""Flow simulation: couples mesh, EOS, rocks, sources and boundary
conditions into jitted timestep functions.

Counterpart of flow_simulation.F90. The simulation owns:
- the host Mesh and its device arrays
- the System (residual + AD Jacobian)
- rock properties per cell (from JSON rock types, rock.F90 defaults)
- Dirichlet boundaries as fixed ghost rows of the solution vector
- the source network (basic sources this round)

JSON schema follows the reference (doc/user/setup_*.rst).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from waiwera_tpu import thermo as thermo_mod
from waiwera_tpu import eos as eos_mod
from waiwera_tpu.mesh.core import Mesh, add_boundaries
from waiwera_tpu.mesh.device import mesh_arrays
from waiwera_tpu.physics import relperm as relperm_mod
from waiwera_tpu.physics import capillarity as cp_mod
from waiwera_tpu.physics.state import (
    DEFAULT_HEAT_CONDUCTIVITY,
    DEFAULT_PERMEABILITY,
    DEFAULT_POROSITY,
    DEFAULT_ROCK_DENSITY,
    DEFAULT_SPECIFIC_HEAT,
    RockState,
)
from waiwera_tpu.sim.network import SourceNetwork
from waiwera_tpu.solver.newton import NewtonParams, newton_solve
from waiwera_tpu.solver.system import MethodCoeffs, System, method_coeffs

Array = jnp.ndarray


class Simulation:
    def __init__(self, config: dict, mesh: Optional[Mesh] = None):
        self.config = config
        self.title = config.get("title", "")

        # thermodynamics (thermodynamics_setup.F90)
        thermo_name = config.get("thermodynamics", "iapws")
        if isinstance(thermo_name, dict):
            thermo_name = thermo_name.get("name", "iapws")
        self.thermo = thermo_mod.from_name(thermo_name)

        # global relative permeability / capillarity (rock.* in JSON)
        rock_cfg = config.get("rock", {}) or {}
        self.relative_permeability = relperm_mod.from_json(
            rock_cfg.get("relative_permeability")
        )
        self.capillary_pressure = cp_mod.from_json(
            rock_cfg.get("capillary_pressure")
        )

        # EOS
        self.eos = eos_mod.from_json(
            config,
            self.thermo,
            self.relative_permeability,
            self.capillary_pressure,
        )
        npv = self.eos.num_primary_variables

        # mesh
        mesh_given = mesh is not None
        if mesh is None:
            mesh = self._mesh_from_config(config)
        self.mesh = mesh
        # gravity semantics (flow_simulation.F90:782-847): scalar g ->
        # -g in the last mesh dimension; missing/null -> 0 for 2D
        # meshes, (0,0,-9.8) for 3D. An explicitly passed mesh keeps
        # its gravity unless the config specifies one.
        if (not mesh_given) or ("gravity" in config):
            from waiwera_tpu.mesh.core import set_gravity

            set_gravity(mesh, self._resolve_gravity(config, mesh.dim))

        # zones (zone.F90:37-80; box / cell-array / combine)
        self.zones = self._setup_zones(config, mesh)

        # MINC dual porosity: append matrix cells (must precede
        # boundaries; mesh.F90 setup_minc_dm)
        mesh_cfg = config.get("mesh")
        minc_cfg = (
            mesh_cfg.get("minc") if isinstance(mesh_cfg, dict) else None
        )
        if minc_cfg:
            from waiwera_tpu.mesh.minc import apply_minc, parse_minc

            self.minc_zones = parse_minc(minc_cfg, self.zones)
            apply_minc(mesh, self.minc_zones)
        else:
            self.minc_zones = []

        # boundaries add ghost cells (must precede rock/initial setup)
        add_boundaries(mesh, config.get("boundaries", []) or [], npv)

        self.mesh_dev = mesh_arrays(mesh)
        n = mesh.num_cells

        # rocks
        self.rock = self._setup_rock(rock_cfg, mesh)

        # tracers (tracer.F90 setup_tracers)
        tracer_cfg = config.get("tracer")
        if tracer_cfg:
            from waiwera_tpu.sim.tracer import TracerSet

            self.tracers = TracerSet(tracer_cfg, self.eos)
        else:
            self.tracers = None

        # source network (source_setup.F90; network config section)
        src_cfg = config.get("source", []) or []
        if isinstance(src_cfg, dict):
            src_cfg = [src_cfg]
        self.sources = (
            SourceNetwork(
                src_cfg, config.get("network", {}) or {}, mesh, self.eos,
                self.thermo,
                tracer_names=self.tracers.names if self.tracers else (),
                zones=self.zones,
            )
            if src_cfg
            else None
        )

        self.system = System(self.eos, self.mesh_dev, self.sources)

        # initial conditions
        self.y0, self.region0 = self._setup_initial(config, mesh)
        if self.tracers is not None:
            self.tracer0 = self._setup_initial_tracer(config, mesh)
        if self.sources is not None:
            fluid0, _ = self.initial_fluid()
            self.sources.finalize(fluid0)

    # ------------------------------------------------------------------

    def _mesh_from_config(self, config) -> Mesh:
        mesh_cfg = config.get("mesh")
        if mesh_cfg is None:
            raise ValueError("no mesh specified")
        if isinstance(mesh_cfg, str):
            mesh_cfg = {"filename": mesh_cfg}
        gravity = None  # resolved after the mesh dimension is known
        radial = bool(mesh_cfg.get("radial", False))
        thickness = float(mesh_cfg.get("thickness", 1.0))
        if "filename" in mesh_cfg:
            fname = mesh_cfg["filename"]
            if fname.lower().endswith((".exo", ".e", ".ex2", ".g")):
                from waiwera_tpu.mesh.exodus import read_exodus

                return read_exodus(
                    fname,
                    gravity=gravity,
                    radial=radial,
                    thickness=thickness,
                )
            from waiwera_tpu.mesh.gmsh import read_gmsh

            return read_gmsh(
                fname,
                gravity=gravity,
                radial=radial,
                thickness=thickness,
            )
        # generator extensions (not in the reference schema)
        if mesh_cfg.get("type") == "column":
            from waiwera_tpu.mesh.rect import column_mesh

            return column_mesh(
                mesh_cfg["dz"], area=mesh_cfg.get("area", 1.0),
                gravity=gravity,
            )
        if mesh_cfg.get("type") == "rectangular":
            from waiwera_tpu.mesh.rect import rectangular_mesh

            return rectangular_mesh(
                mesh_cfg.get("dx"),
                mesh_cfg.get("dy"),
                mesh_cfg.get("dz"),
                gravity=gravity,
                radial=radial,
                thickness=thickness,
            )
        raise ValueError(f"cannot build mesh from: {mesh_cfg!r}")

    @staticmethod
    def _resolve_gravity(config, dim: int):
        g = config.get("gravity", None)
        if g is None:
            mag = 0.0 if dim == 2 else 9.8
            out = np.zeros(3)
            out[dim - 1] = -mag
            return out
        if isinstance(g, (int, float)):
            out = np.zeros(3)
            out[dim - 1] = -float(g)
            return out
        out = np.zeros(3)
        arr = np.asarray(g, dtype=np.float64)
        out[: len(arr)] = arr
        return out

    def _setup_zones(self, config, mesh: Mesh):
        """Resolve mesh zones to interior cell index arrays
        (zone.F90:37-80: cell-array, coordinate box, combine)."""
        mesh_cfg = config.get("mesh")
        zcfg = (
            mesh_cfg.get("zones", {}) if isinstance(mesh_cfg, dict) else {}
        ) or {}
        zones = {}
        centroid = mesh.cell_centroid[: mesh.num_interior_cells]
        axes = "xyz"[: mesh.dim] if mesh.dim <= 3 else "xyz"
        pending = dict(zcfg)
        while pending:
            progressed = False
            for name, spec in list(pending.items()):
                if not isinstance(spec, dict):
                    spec = {"cells": spec}
                ztype = spec.get("type")
                if ztype is None:
                    ztype = (
                        "array" if "cells" in spec
                        else ("combine" if ("+" in spec or "-" in spec)
                              else "box")
                    )
                if ztype == "array":
                    cells = np.asarray(spec.get("cells", []), np.int64)
                elif ztype == "combine":
                    def names_of(v):
                        if v is None:
                            return []
                        return [
                            z for z in np.atleast_1d(v) if z is not None
                        ]

                    plus = names_of(spec.get("+"))
                    minus = names_of(spec.get("-"))
                    if not all(z in zones for z in plus + minus):
                        continue
                    if plus or "+" in spec:
                        sel = np.zeros(mesh.num_interior_cells, bool)
                        for z in plus:
                            sel[zones[z]] = True
                    else:
                        # '-' only: start from all cells (zone.F90
                        # combine semantics)
                        sel = np.ones(mesh.num_interior_cells, bool)
                    for z in minus:
                        sel[zones[z]] = False
                    cells = np.flatnonzero(sel)
                else:  # box
                    sel = np.ones(mesh.num_interior_cells, bool)
                    for k, ax in enumerate(axes):
                        if ax in spec and spec[ax] is not None:
                            lo, hi = spec[ax]
                            sel &= (centroid[:, k] >= lo) & (
                                centroid[:, k] <= hi
                            )
                    cells = np.flatnonzero(sel)
                zones[name] = cells
                del pending[name]
                progressed = True
            if not progressed:
                raise ValueError("cyclic or undefined zone references")
        return zones

    def _zone_cells(self, names):
        sel = np.zeros(self.mesh.num_interior_cells, bool)
        for nm in np.atleast_1d(names):
            if nm not in self.zones:
                raise ValueError(f"unknown zone {nm!r}")
            sel[self.zones[nm]] = True
        return np.flatnonzero(sel)

    @staticmethod
    def _is_table_spec(v) -> bool:
        """Rank-2 array spec = time table (rock_setup.F90:304-312: a
        rank-2 "permeability"/"porosity" is a table of values vs time
        driving a rock control)."""
        if not isinstance(v, (list, tuple, np.ndarray)):
            return False
        a = np.asarray(v, dtype=object)
        return a.ndim >= 2 or (
            len(v) > 0 and isinstance(v[0], (list, tuple, np.ndarray))
        )

    def _setup_rock(self, rock_cfg, mesh: Mesh) -> RockState:
        from waiwera_tpu.utils.interpolation import InterpolationTable

        n = mesh.num_cells
        perm = np.full((n, 3), DEFAULT_PERMEABILITY)
        wetk = np.full(n, DEFAULT_HEAT_CONDUCTIVITY)
        dryk = np.full(n, DEFAULT_HEAT_CONDUCTIVITY)
        poro = np.full(n, DEFAULT_POROSITY)
        dens = np.full(n, DEFAULT_ROCK_DENSITY)
        sph = np.full(n, DEFAULT_SPECIFIC_HEAT)
        # time-dependent rock property controls
        # (flow_simulation.F90:62,2050-2094, rock_control.F90)
        self.rock_controls = []
        for rt in rock_cfg.get("types", []) or []:
            if "zones" in rt:
                cells = self._zone_cells(rt["zones"])
            elif "cells" in rt:
                # an explicitly empty list assigns no cells (the type
                # may still be referenced by MINC fracture/matrix rock)
                cells = np.asarray(rt["cells"], dtype=np.int64)
            else:
                cells = np.arange(mesh.num_interior_cells)
            interp = str(rt.get("interpolation", "linear")).lower()
            k_spec = rt.get("permeability", DEFAULT_PERMEABILITY)
            if self._is_table_spec(k_spec):
                self.rock_controls.append(
                    (
                        "permeability",
                        np.asarray(cells, np.int64),
                        InterpolationTable(k_spec, interpolation=interp),
                    )
                )
                k = np.atleast_1d(np.asarray(DEFAULT_PERMEABILITY))
            else:
                k = np.atleast_1d(np.asarray(k_spec, dtype=np.float64))
            if len(k) < 3:
                k = np.concatenate([k, np.full(3 - len(k), k[-1])])
            perm[cells] = k
            p_spec = rt.get("porosity", DEFAULT_POROSITY)
            if self._is_table_spec(p_spec):
                self.rock_controls.append(
                    (
                        "porosity",
                        np.asarray(cells, np.int64),
                        InterpolationTable(p_spec, interpolation=interp),
                    )
                )
            else:
                poro[cells] = p_spec
            wetk[cells] = rt.get(
                "wet_conductivity", DEFAULT_HEAT_CONDUCTIVITY
            )
            dryk[cells] = rt.get(
                "dry_conductivity", DEFAULT_HEAT_CONDUCTIVITY
            )
            dens[cells] = rt.get("density", DEFAULT_ROCK_DENSITY)
            sph[cells] = rt.get("specific_heat", DEFAULT_SPECIFIC_HEAT)
        # MINC fracture/matrix rock types by name
        # (mesh_setup_minc_rock_properties)
        by_name = {
            rt.get("name", ""): rt
            for rt in rock_cfg.get("types", []) or []
        }
        for cells, name in getattr(mesh, "minc_rock", []):
            rt = by_name.get(name)
            if rt is None:
                raise ValueError(f"unknown MINC rock type {name!r}")
            k = np.atleast_1d(
                np.asarray(
                    rt.get("permeability", DEFAULT_PERMEABILITY),
                    dtype=np.float64,
                )
            )
            if len(k) < 3:
                k = np.concatenate([k, np.full(3 - len(k), k[-1])])
            perm[cells] = k
            wetk[cells] = rt.get(
                "wet_conductivity", DEFAULT_HEAT_CONDUCTIVITY
            )
            dryk[cells] = rt.get(
                "dry_conductivity", DEFAULT_HEAT_CONDUCTIVITY
            )
            poro[cells] = rt.get("porosity", DEFAULT_POROSITY)
            dens[cells] = rt.get("density", DEFAULT_ROCK_DENSITY)
            sph[cells] = rt.get("specific_heat", DEFAULT_SPECIFIC_HEAT)

        # ghost cells inherit the attached interior cell's rock so
        # harmonic face averages see interior properties
        ghosts = []
        interiors = []
        for b in mesh.boundaries:
            for ghost, face in zip(b.cells, b.faces):
                interior = mesh.face_cells[face, 0]
                ghosts.append(ghost)
                interiors.append(interior)
                perm[ghost] = perm[interior]
                wetk[ghost] = wetk[interior]
                dryk[ghost] = dryk[interior]
                poro[ghost] = poro[interior]
                dens[ghost] = dens[interior]
                sph[ghost] = sph[interior]
        self._rock_ghost_map = (
            np.asarray(ghosts, np.int64),
            np.asarray(interiors, np.int64),
        )
        if self.rock_controls:
            self._rock_np = {"permeability": perm, "porosity": poro}
        return RockState(
            permeability=jnp.asarray(perm),
            wet_conductivity=jnp.asarray(wetk),
            dry_conductivity=jnp.asarray(dryk),
            porosity=jnp.asarray(poro),
            density=jnp.asarray(dens),
            specific_heat=jnp.asarray(sph),
        )

    def rock_for(self, t: float) -> RockState:
        """Rock properties at time t: applies the table-driven rock
        controls (pre-try-timestep hook,
        flow_simulation.F90:2050-2094). Returns self.rock unchanged
        when no controls exist."""
        if not self.rock_controls:
            return self.rock
        perm = self._rock_np["permeability"].copy()
        poro = self._rock_np["porosity"].copy()
        for kind, cells, table in self.rock_controls:
            val = np.asarray(table(t))
            if kind == "permeability":
                k = np.atleast_1d(val)
                if len(k) < 3:
                    k = np.concatenate(
                        [k, np.full(3 - len(k), k[-1])]
                    )
                perm[cells] = k
            else:
                poro[cells] = val[..., 0] if val.ndim else val
        g, i = self._rock_ghost_map
        perm[g] = perm[i]
        poro[g] = poro[i]
        return self.rock._replace(
            permeability=jnp.asarray(perm),
            porosity=jnp.asarray(poro),
        )

    def _setup_initial(self, config, mesh: Mesh):
        """Initial primary variables and regions (initial.F90, constant
        or per-cell arrays, or restart from an HDF5 output file),
        plus boundary values in ghost rows."""
        npv = self.eos.num_primary_variables
        n = mesh.num_cells
        ic = config.get("initial", {}) or {}
        primary = np.tile(self.eos.default_primary, (n, 1))
        region = np.full(n, self.eos.default_region, dtype=np.int32)
        if "filename" in ic and ic["filename"]:
            p, r = self._initial_from_file(ic, mesh)
            primary[: len(p)] = p
            region[: len(r)] = r
        if "primary" in ic:
            p = np.asarray(ic["primary"], dtype=np.float64)
            if p.ndim == 1:
                primary[: mesh.num_interior_cells] = p
            else:
                primary[: len(p)] = p
        if "region" in ic:
            r = np.asarray(ic["region"], dtype=np.int32)
            if r.ndim == 0:
                region[: mesh.num_interior_cells] = r
            else:
                region[: len(r)] = r
        # MINC matrix cells inherit their fracture cell's initial
        # state (initial.F90:976+)
        lvl = getattr(mesh, "minc_level", None)
        if lvl is not None and (lvl > 0).any():
            par = mesh.minc_parent
            matrix = lvl > 0
            primary[np.flatnonzero(matrix)] = primary[par[matrix]]
            region[np.flatnonzero(matrix)] = region[par[matrix]]
        # boundary ghost rows
        for b in mesh.boundaries:
            primary[b.cells] = b.primary
            region[b.cells] = b.region
        region_j = jnp.asarray(region, jnp.int32)
        y = self.eos.scale(jnp.asarray(primary), region_j)
        return y, region_j

    def _initial_from_file(self, ic, mesh: Mesh):
        """Restart from an HDF5 output file (initial.F90:421-679):
        loads the EOS's required output fluid fields at the given time
        index (default -1 = last), mapped by natural cell index.

        The reference distinguishes 'minimal' (required fields ->
        primaries) from 'full fluid vector' restarts because its fluid
        Vec is stateful between steps. Here the fluid state is a pure
        function of (primary, region) recomputed every residual, so
        the minimal restart IS exact continuation: any extra fluid
        fields in the file are derived quantities that the first
        residual evaluation reproduces bit-for-bit from the loaded
        primaries."""
        import h5py

        index = ic.get("index", -1)
        index = -1 if index is None else int(index)
        with h5py.File(ic["filename"], "r") as f:
            cf = f["cell_fields"]
            order = np.asarray(f["cell_index"][:, 0], np.int64)
            inv = np.argsort(order)
            fields = {}
            for name in self.eos.required_output_fluid_fields:
                ds = f"fluid_{name}" if f"fluid_{name}" in cf else name
                fields[name] = np.asarray(cf[ds][index])[inv]
            self._restart_tracer_fields = {}
            if self.tracers is not None:
                for nm in self.tracers.names:
                    ds = f"tracer_{nm}"
                    if ds in cf:
                        self._restart_tracer_fields[nm] = np.asarray(
                            cf[ds][index]
                        )[inv]
        return self.eos.primary_from_output_fields(fields)

    def _setup_initial_tracer(self, config, mesh: Mesh):
        """[N, nt] initial tracer mass fractions, with boundary values
        in ghost rows."""
        nt = self.tracers.num_tracers
        n = mesh.num_cells
        x = np.zeros((n, nt))
        ic = config.get("initial", {}) or {}
        tr = ic.get("tracer")
        if tr is not None:
            arr = np.asarray(tr, dtype=np.float64)
            if arr.ndim == 0:
                x[: mesh.num_interior_cells] = float(arr)
            elif arr.ndim == 1 and arr.shape[0] == nt:
                x[: mesh.num_interior_cells] = arr
            else:
                x[: mesh.num_interior_cells] = arr.reshape(
                    mesh.num_interior_cells, -1
                )
        for nm, vals in getattr(self, "_restart_tracer_fields",
                                {}).items():
            k = self.tracers.names.index(nm)
            x[: mesh.num_interior_cells, k] = vals
        for b in mesh.boundaries:
            if b.tracer is not None:
                bt = b.tracer
                if bt.shape[0] != nt:
                    bt = np.full(nt, bt[0])
                x[b.cells] = bt
        return jnp.asarray(x)

    # ------------------------------------------------------------------

    def initial_fluid(self):
        """fluid_init equivalent: full property evaluation at the
        initial solution (flow_simulation.F90:2171)."""
        fluid, err = self.eos.properties(
            self.eos.unscale(self.y0, self.region0), self.region0, self.rock
        )
        return fluid, err

    def make_step_fn(self, newton_params: NewtonParams, method: str = "beuler"):
        """Build the jitted one-timestep-try function.

        Traced arguments: y_last, region, temperature, lhs_last,
        lhs_last2, t_last, dt, dt_last, first(bool as float mask).
        """
        system = self.system
        eos = self.eos
        rock = self.rock
        sources = self.sources
        mesh = self.mesh_dev

        @jax.jit
        def step(y, region, temperature, lhs_last, lhs_last2, t_last, dt,
                 dt_last, first, rock_in=None, fluid_last=None,
                 fluxes_last=None):
            # rock_in: time-varying rock properties from rock controls
            # (rock_for at pre-try-timestep); None uses the static rock
            # fluid_last/fluxes_last: the previous accepted step's
            # fluid state and face fluxes at (y, region) — enables the
            # initial-residual reuse in newton_solve (invalid when
            # rock_in changes the rock those were computed with)
            rock = self.rock if rock_in is None else rock_in
            t0 = t_last
            t1 = t_last + dt
            coeffs = method_coeffs(
                method, dt, dt_last, first, lhs_last, lhs_last2
            )
            initial = None
            if rock_in is None and fluid_last is not None \
                    and fluxes_last is not None:
                initial = (fluid_last, lhs_last, fluxes_last)
            res = newton_solve(
                system,
                y,
                region,
                temperature,
                rock,
                coeffs,
                t0,
                t1,
                lhs_scale=lhs_last,
                params=newton_params,
                initial=initial,
            )
            # final-iterate state carried out of the Newton loop — no
            # post-solve re-evaluation of the f64 EOS chain
            fluid, lhs_new, fluxes = res.fluid, res.lhs, res.fluxes
            res = res._replace(fluid=None, lhs=None, fluxes=None)
            return res, fluid, lhs_new, fluxes

        return step

    def make_tracer_step_fn(self):
        """Jitted auxiliary tracer solve for one accepted timestep
        (timestepper.F90:458-557 linear setup; aux solve
        :2347-2356)."""
        from waiwera_tpu.sim import tracer as tracer_mod

        tracers = self.tracers
        mesh = self.mesh_dev
        rock = self.rock
        network = self.sources
        npv = self.eos.num_primary_variables
        ghost_value = jnp.asarray(self.tracer0)

        @jax.jit
        def tracer_step(fluid, fluxes, x_last, al_last, x_last2, al_last2,
                        t0, t1, dt, dt_last, first, use_bdf2):
            if network is not None and network.num_sources > 0:
                rate, _ = network.flows(fluid, t0, t1)
                cells = network.arrays.cell
                frac = fluid.phase_flow_fractions()[cells][
                    :, jnp.asarray(tracers.phase_index)
                ]
                inj = network.tracer_injection(t0, t1)
            else:
                rate = None
                cells = None
                frac = None
                inj = None
            r = dt / dt_last
            be = (~use_bdf2) | (first > 0.5)
            c_al = jnp.where(be, 1.0, 1.0 + 2.0 * r)
            dt_eff = jnp.where(be, dt, dt * (r + 1.0))
            b_hist = jnp.where(
                be,
                al_last * x_last,
                (r + 1.0) ** 2 * al_last * x_last
                - r * r * al_last2 * x_last2,
            )
            return tracer_mod.solve(
                tracers,
                mesh,
                fluid,
                rock,
                fluxes,
                npv,
                x_last,
                al_last,
                x_last2,
                al_last2,
                c_al,
                dt_eff,
                b_hist,
                cells,
                rate,
                frac,
                inj,
                ghost_value,
                system=self.system,
            )

        return tracer_step

    def initial_tracer_state(self):
        """(x0, al0) at the initial fluid state."""
        from waiwera_tpu.sim import tracer as tracer_mod

        fluid0, _ = self.initial_fluid()
        al0 = tracer_mod.balance_coefs(self.tracers, fluid0, self.rock)
        return jnp.asarray(self.tracer0), al0

    def lhs_at(self, y, region):
        fluid, cond, err = self.system.derived_state(y, region, self.rock)
        return self.system.lhs(fluid, self.rock), fluid, err

    def initial_fluxes(self, y, region):
        """Face fluxes in the step function's canonical face order at
        an initial state — seeds the timestep loop's carried-state
        fast path (newton_solve initial=)."""
        fluid, cond, _ = self.system.derived_state(y, region, self.rock)
        return self.system.fluxes(fluid, cond, self.rock)

    def fluxes_at(self, y, region):
        """[F, nflux] face fluxes at a state in the host mesh's natural
        face order (for initial flux output;
        flow_simulation.F90 initial_function_calls computes the RHS at
        t0 when initial output is requested)."""
        fluid, cond, _ = self.system.derived_state(y, region, self.rock)
        return self.flux_to_global(
            self.system.fluxes(fluid, cond, self.rock)
        )

    def flux_to_global(self, fluxes):
        """Canonical (band-sorted) face order -> natural host face
        order/orientation for /face_fields output."""
        from waiwera_tpu.mesh.device import fluxes_to_host_order

        return fluxes_to_host_order(self.mesh_dev, fluxes)

    def dof_statistics(self) -> dict:
        """DOF totals + per-device imbalance (Kumar et al. 1994),
        flow_simulation.F90:2998-3019. Single device: no imbalance.
        banded: whether the Jacobian packs into DIA bands without a
        BSR scatter and gather (pure or hybrid band plan)."""
        n = int(self.mesh.num_interior_cells)
        npv = self.eos.num_primary_variables
        return {
            "total": n * npv,
            "min": n * npv,
            "max": n * npv,
            "imbalance": 0.0,
            "banded": (
                self.system.band_plan is not None
                or self.system.hybrid is not None
            ),
        }
