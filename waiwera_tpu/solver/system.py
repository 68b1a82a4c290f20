"""The nonlinear system: residual and AD block Jacobian.

Replaces the reference's FD-coloring machinery
(timestepper.F90:1584-1607, flow_simulation.F90 pre_eval/update_cell
caching) with an exact forward-mode block Jacobian: because balances and
sources are cell-local and fluxes are face-local in the gathered pair
representation, npv JVP passes over the cell chain plus 2*npv over the
flux chain yield all BSR blocks directly. Regions are frozen during
differentiation, matching the reference's FD-at-frozen-region behaviour
(doc/dev/code/index.md:37-39).

Residual (timestepper.F90:345-452), generalised over methods:
    r = c_L * L(y) + const - dt_eff * R(y)
with backward Euler: c_L = 1, dt_eff = dt, const = -L_old;
BDF2:  c_L = 1+2r, dt_eff = dt (r+1),
       const = -(r+1)^2 L_old + r^2 L_old2;
direct steady state: c_L = 0, dt_eff = -1, const = 0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from waiwera_tpu.mesh.device import MeshArrays
from waiwera_tpu.physics import assembly
from waiwera_tpu.physics.state import FluidState, RockState
from waiwera_tpu.ops import dia, ell
from waiwera_tpu.sim.sources import source_inflows
from waiwera_tpu.solver import bsr

Array = jnp.ndarray


class MethodCoeffs(NamedTuple):
    c_lhs: Array  # scalar
    dt_eff: Array  # scalar
    const: Array  # [N, npv]


def method_coeffs(
    method: str, dt, dt_last, first, lhs_last, lhs_last2
) -> MethodCoeffs:
    """Residual coefficients for the time integration methods
    (timestepper.F90:345-452): backward Euler, variable-step BDF2
    (BE on the first step), direct steady state. `first` is a float
    mask (>0.5 on the run's first step)."""
    if method == "directss":
        return MethodCoeffs(
            c_lhs=jnp.asarray(0.0),
            dt_eff=jnp.asarray(-1.0),
            const=jnp.zeros_like(lhs_last),
        )
    if method == "bdf2":
        r = dt / dt_last
        use_be = first > 0.5
        c_l = jnp.where(use_be, 1.0, 1.0 + 2.0 * r)
        dt_eff = jnp.where(use_be, dt, dt * (r + 1.0))
        const = jnp.where(
            use_be,
            -lhs_last,
            -((r + 1.0) ** 2) * lhs_last + (r * r) * lhs_last2,
        )
        return MethodCoeffs(c_lhs=c_l, dt_eff=dt_eff, const=const)
    return MethodCoeffs(
        c_lhs=jnp.asarray(1.0), dt_eff=dt, const=-lhs_last
    )


class System:
    """Couples an EOS, mesh and sources into residual/Jacobian
    evaluations on dense arrays."""

    def __init__(self, eos, mesh: MeshArrays, network=None):
        """network: Optional[SourceNetwork] (sim.network) providing the
        per-residual source update flows(fluid, t0, t1)."""
        self.eos = eos
        self.mesh = mesh
        self.network = network
        self.npv = eos.num_primary_variables
        self.isothermal = eos.isothermal
        face_cells = np.asarray(mesh.face_cells)
        self.structure = bsr.build_structure(
            mesh.num_cells, face_cells, self.npv
        )
        pos_lr, pos_rl = bsr.face_block_positions(self.structure, face_cells)
        self.pos_lr = jnp.asarray(pos_lr, jnp.int32)
        self.pos_rl = jnp.asarray(pos_rl, jnp.int32)
        self.ell = ell.ell_structure(self.structure)
        # banded fast path (rectilinear meshes in natural order):
        # shift-based SpMV with no index gather at all
        self.dia = dia.dia_structure(
            self.structure, np.asarray(mesh.is_ghost)
        )
        # gather-free band packing recipe: the Jacobian's block parts
        # pack into bands by reshape/pad, with no BSR scatter + gather
        # round trip
        self.band_plan = (
            dia.band_plan(
                self.dia, face_cells, np.asarray(mesh.is_ghost)
            )
            if self.dia is not None
            else None
        )
        # periodic-slice face gather/scatter (canonical face order):
        # face-state gathers and inflow scatter-adds become slices
        self.face_plan = (
            dia.face_plan(self.band_plan, self.dia.offsets)
            if self.band_plan is not None
            else None
        )
        # hybrid DIA + indexed tail: meshes that are banded except for
        # a face tail (MINC fracture-matrix chains appended to a
        # rectilinear lattice) keep the slicing fast path for the
        # planned prefix, with the tail handled by small indexed
        # gathers in the matvec/scatter helpers
        self.hybrid = None
        if self.face_plan is None:
            fpd = dia.face_plan_direct(
                face_cells, np.asarray(mesh.is_ghost), mesh.num_cells
            )
            if fpd is not None:
                self.face_plan = fpd
                # may be None (too many bands): the face plan still
                # accelerates residual gathers/scatters; the linear
                # operator then falls back to BSR/ELL
                self.hybrid = dia.hybrid_band_structures(
                    fpd, mesh.num_cells, self.npv
                )
        if self.face_plan is not None:
            fl_ = self.face_plan.f_live
            self._tail_cl = jnp.asarray(face_cells[fl_:, 0], jnp.int32)
            self._tail_cr = jnp.asarray(face_cells[fl_:, 1], jnp.int32)

    # -- plan-based face data movement --------------------------------

    def _face_gather_leaf(self, a, right: bool):
        """One [N, ...] array -> [F, ...] per-face values of the left
        (cl) or right (cr) cell; slices via the face plan, indexed
        gather only for the ghost-face tail."""
        fp = self.face_plan
        nf = self.mesh.face_cells.shape[0]
        if isinstance(a, np.ndarray) and a.dtype == jax.dtypes.float0:
            return np.zeros((nf,) + a.shape[1:], jax.dtypes.float0)
        head = dia.plan_gather_cells(fp, a, right)
        tail_idx = self._tail_cr if right else self._tail_cl
        if int(tail_idx.shape[0]):
            return jnp.concatenate([head, a[tail_idx]], axis=0)
        return head

    def gather_face(self, a, right: bool = False):
        """Public per-leaf face gather on this System's own mesh:
        [N, ...] cell values -> [F, ...] left- (cl) or right-side (cr)
        face values, plan-based when the periodic face structure was
        detected (indexed fallback otherwise)."""
        if self.face_plan is None:
            idx = self.mesh.face_cells[:, 1 if right else 0]
            return a[idx]
        return self._face_gather_leaf(a, right)

    def gather_face_sides(self, tree):
        """(left, right) per-face pytrees of a cell-state pytree."""
        if self.face_plan is None:
            cl = self.mesh.face_cells[:, 0]
            cr = self.mesh.face_cells[:, 1]
            return (
                assembly.gather_state(tree, cl),
                assembly.gather_state(tree, cr),
            )
        l = jax.tree_util.tree_map(
            lambda a: self._face_gather_leaf(a, False), tree
        )
        r = jax.tree_util.tree_map(
            lambda a: self._face_gather_leaf(a, True), tree
        )
        return l, r

    def scatter_face_sides(self, vals_l, vals_r, mesh=None):
        """Accumulate per-face values into cells: vals_l into cl rows,
        vals_r into cr rows ([F, ...] -> [N, ...])."""
        if mesh is None:
            mesh = self.mesh
        n = mesh.num_cells
        if self.face_plan is None:
            out = jnp.zeros((n,) + vals_l.shape[1:], vals_l.dtype)
            return (
                out.at[mesh.face_cells[:, 0]].add(vals_l)
                .at[mesh.face_cells[:, 1]].add(vals_r)
            )
        fp = self.face_plan
        out = dia.plan_scatter_add_cells(
            fp, vals_l[: fp.f_live], n, False
        ) + dia.plan_scatter_add_cells(fp, vals_r[: fp.f_live], n, True)
        if int(self._tail_cl.shape[0]):
            out = (
                out.at[self._tail_cl].add(vals_l[fp.f_live :])
                .at[self._tail_cr].add(vals_r[fp.f_live :])
            )
        return out

    def scatter_face_sides_em(self, vals_l2, vals_r2, mesh=None):
        """scatter_face_sides with the face/cell axis LAST
        ([..., F] -> [..., N]); used for element-major block data."""
        if mesh is None:
            mesh = self.mesh
        n = mesh.num_cells
        if self.face_plan is None:
            out = jnp.zeros(vals_l2.shape[:-1] + (n,), vals_l2.dtype)
            return (
                out.at[..., mesh.face_cells[:, 0]].add(vals_l2)
                .at[..., mesh.face_cells[:, 1]].add(vals_r2)
            )
        fp = self.face_plan
        out = dia.plan_scatter_add_cells_last(
            fp, vals_l2[..., : fp.f_live], n, False
        ) + dia.plan_scatter_add_cells_last(
            fp, vals_r2[..., : fp.f_live], n, True
        )
        if int(self._tail_cl.shape[0]):
            out = (
                out.at[..., self._tail_cl].add(vals_l2[..., fp.f_live :])
                .at[..., self._tail_cr].add(vals_r2[..., fp.f_live :])
            )
        return out

    def _perm_sides(self, rock: RockState, mesh=None):
        if mesh is None:
            mesh = self.mesh
        if self.face_plan is None:
            return assembly.face_permeability_sides(rock, mesh)
        pl = self._face_gather_leaf(rock.permeability, False)
        pr = self._face_gather_leaf(rock.permeability, True)
        dir_ = mesh.face_permeability_direction[:, None]
        perm_l = jnp.take_along_axis(pl, dir_, axis=1)[:, 0]
        perm_r = jnp.take_along_axis(pr, dir_, axis=1)[:, 0]
        return perm_l, perm_r

    def _inflows(self, fluxes: Array, mesh=None) -> Array:
        """cell_inflows via the face plan when available."""
        if mesh is None:
            mesh = self.mesh
        if self.face_plan is None:
            return assembly.cell_inflows(fluxes, mesh, self.npv)
        flow = fluxes[:, : self.npv] * mesh.face_area[:, None]
        rhs = self.scatter_face_sides(-flow, flow, mesh)
        vol = jnp.where(mesh.cell_volume > 0.0, mesh.cell_volume, 1.0)
        rhs = rhs / vol[:, None]
        return jnp.where(mesh.is_ghost[:, None], 0.0, rhs)

    # -- parallel hooks (overridden by parallel.spmd.LocalSystem) -----
    # On a single device these are identities; under shard_map they
    # become XLA collectives / halo exchanges, so newton_solve and the
    # Krylov solvers run unchanged over domain-decomposed arrays.

    @property
    def interior_mask(self) -> Array:
        """Rows that count in norms/reductions (non-ghost; distributed:
        owned and non-ghost)."""
        return ~self.mesh.is_ghost

    @property
    def update_mask(self) -> Array:
        """Rows whose primaries move in a Newton update (non-ghost,
        including halo copies of remote interior cells)."""
        return ~self.mesh.is_ghost

    def reduce_sum(self, x: Array) -> Array:
        return x

    def reduce_max(self, x: Array) -> Array:
        return x

    def reduce_any(self, x: Array) -> Array:
        return x

    def sync(self, x):
        """Halo exchange (PetscSF DMGlobalToLocal analogue); identity
        on a single device."""
        return x

    def to_global_cell(self, cell: Array) -> Array:
        """Local row index -> global/natural cell index for
        observability (AO analogue, dm_utils.F90:843-935); identity on
        a single device."""
        return cell

    def make_matvec(self, mat, dtype=None):
        """SpMV closure for the Krylov solve: assembled BSR data is
        re-laid-out once (amortised over the Krylov iterations) into
        scatter-free DIA bands (banded/structured meshes) or ELL
        (ops.ell, unstructured), optionally down-cast (f32 inner
        solves)."""
        if self.dia is not None:
            return dia.to_dia(mat, self.dia, dtype).matvec
        return ell.to_ell(mat, self.ell, dtype).matvec

    def make_linear_operator(self, mat, pc_name, dtype=None, sweeps=3):
        """(matvec, preconditioner) for the Krylov solve, sharing one
        band/ELL layout pass. Factorisations (block inverses, DILU
        modified diagonal) run in f64; applications run in `dtype`."""
        from waiwera_tpu.solver import precond as _precond
        from waiwera_tpu.solver.smallblocks import invert_blocks

        if self.dia is not None:
            m64 = dia.to_dia(mat, self.dia)
            if dtype is None:
                m = m64
            else:
                m = m64._replace(bands=m64.bands.astype(dtype))
            if pc_name in ("none",):
                pc = lambda r: r
            elif pc_name in ("bjacobi", "jacobi"):
                dinv = invert_blocks(dia.diag_band_blocks(m64))
                pc = dia.dia_block_jacobi(dinv, dtype)
            elif pc_name in ("lu",):
                pc = _precond.lu(mat, dtype=dtype)
            elif pc_name in ("line", "zline"):
                pc = dia.dia_line_pc_em(m64, dtype=dtype)
                if pc is None:  # no +-offset pair: fall back
                    dinv = invert_blocks(dia.diag_band_blocks(m64))
                    pc = dia.dia_block_jacobi(dinv, dtype)
            elif pc_name in ("cpr", "cprmg"):
                from waiwera_tpu.ops import mg as ops_mg

                built = ops_mg.pressure_levels(m64, dtype=dtype)
                dinv = invert_blocks(dia.diag_band_blocks(m64))
                bj = dia.dia_block_jacobi(dinv, dtype)
                if built is None:
                    pc = bj
                else:
                    levels, dims = built
                    pc = ops_mg.cpr_apply(
                        levels, dims, m.matvec, bj,
                        self.mesh.num_cells, self.npv,
                    )
            else:  # asm / ilu / dilu / sgs -> shift-based DILU
                pc = dia.dia_dilu(
                    m64, invert_blocks, sweeps=sweeps, dtype=dtype
                )
            return m.matvec, pc
        mv = ell.to_ell(mat, self.ell, dtype).matvec
        pc = _precond.make_preconditioner(
            "bjacobi" if pc_name in ("line", "zline") else pc_name,
            mat, sweeps=sweeps, dtype=dtype,
        )
        return mv, pc

    # -- state chains -------------------------------------------------

    def derived_state(self, y: Array, region: Array, rock: RockState):
        """Scaled primaries -> (fluid, conductivity, err)."""
        # named scopes mirror the reference's profiling events
        # (profiling.F90:28-64): fluid_props, cell_balances,
        # cell_inflows, sources — visible in jax.profiler traces
        with jax.named_scope("fluid_props"):
            primary = self.eos.unscale(y, region)
            fluid, err = self.eos.properties(primary, region, rock)
            cond = (
                None
                if self.isothermal
                else self.eos.conductivity(rock, fluid)
            )
        return fluid, cond, err

    def lhs(self, fluid: FluidState, rock: RockState) -> Array:
        """Cell balances, zero in ghost cells."""
        with jax.named_scope("cell_balances"):
            L = assembly.cell_balances(fluid, rock, self.npv)
            return jnp.where(self.mesh.is_ghost[:, None], 0.0, L)

    def source_term(self, fluid, t0, t1) -> Array:
        """Cell inflows from the source network at the current fluid
        state (flow_simulation.F90:1468: network update + q/V
        assembly). The network update is traced here, so
        fluid-dependent rates (deliverability, recharge, production
        enthalpy) enter the AD Jacobian's diagonal blocks."""
        if self.network is None or self.network.num_sources == 0:
            return jnp.zeros((self.mesh.num_cells, self.npv))
        with jax.named_scope("sources"):
            rate, enthalpy = self.network.flows(fluid, t0, t1)
            return source_inflows(
                fluid,
                self.network.arrays,
                rate,
                enthalpy,
                self.npv,
                self.eos.num_components,
                self.mesh.num_cells,
                self.isothermal,
            )

    def fluxes(self, fluid, cond, rock) -> Array:
        if self.face_plan is None:
            return assembly.face_fluxes(
                fluid,
                rock,
                cond,
                self.mesh,
                self.npv,
                self.eos.num_mobile_phases,
                self.isothermal,
            )
        fl, fr = self.gather_face_sides(fluid)
        perm_l, perm_r = self._perm_sides(rock)
        cdl = cdr = None
        if not self.isothermal:
            cdl = self._face_gather_leaf(cond, False)
            cdr = self._face_gather_leaf(cond, True)
        return assembly.face_fluxes_pairs(
            fl,
            fr,
            perm_l,
            perm_r,
            cdl,
            cdr,
            self.mesh,
            self.npv,
            self.eos.num_mobile_phases,
            self.isothermal,
        )

    def rhs(self, fluid, cond, rock, t0, t1):
        """Net cell inflows (per unit volume) = flux divergence +
        sources. Returns (rhs [N, npv], fluxes [F, nf])."""
        with jax.named_scope("cell_inflows"):
            fluxes = self.fluxes(fluid, cond, rock)
            inflow = self._inflows(fluxes)
        inflow = inflow + self.source_term(fluid, t0, t1)
        return jnp.where(self.mesh.is_ghost[:, None], 0.0, inflow), fluxes

    # -- residual -----------------------------------------------------

    def residual(
        self,
        y: Array,
        region: Array,
        rock: RockState,
        coeffs: MethodCoeffs,
        t0: Array,
        t1: Array,
    ):
        """Returns (residual [N, npv], lhs [N, npv], fluxes, err[N])."""
        fluid, cond, err = self.derived_state(y, region, rock)
        L = self.lhs(fluid, rock)
        R, fluxes = self.rhs(fluid, cond, rock, t0, t1)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
        r = jnp.where(self.mesh.is_ghost[:, None], 0.0, r)
        return r, L, fluxes, err

    def residual_from_state(self, fluid, L, fluxes, coeffs, t0, t1):
        """Residual at a state whose (fluid, balances, face fluxes)
        are already in hand — the previous accepted step's outputs.
        Face fluxes depend only on the fluid state, so only the
        time-dependent source-network inflows are re-evaluated; the
        result follows exactly the residual() formula. This is the
        assembled-state analogue of the reference's cached
        balance/flux reuse (flow_simulation.F90:851-878, 1429-1444)."""
        ghost = self.mesh.is_ghost[:, None]
        inflow = self._inflows(fluxes) + self.source_term(fluid, t0, t1)
        R = jnp.where(ghost, 0.0, inflow)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
        return jnp.where(ghost, 0.0, r)

    # -- residual + block Jacobian -------------------------------------

    def residual_and_jacobian(
        self,
        y: Array,
        region: Array,
        rock: RockState,
        coeffs: MethodCoeffs,
        t0: Array,
        t1: Array,
        tangent_dtype=None,
    ):
        """Returns (residual, lhs, fluxes, err, BSRMatrix).

        tangent_dtype=float32: evaluate the Jacobian chain (EOS
        property tangents, flux tangents, block assembly) in f32 while
        the residual stays f64. The Jacobian only steers the Newton
        direction (the reference's own Jacobian is FD noise-limited to
        ~1e-8, timestepper.F90:1626), so f32 tangents (~1e-6 relative)
        preserve quadratic-ish convergence at a fraction of the
        assembly cost. Implemented by tracing the same code under
        jax.enable_x64(False), which downcasts every array and constant
        in the chain.
        """
        r, L, fluxes, err, parts = self.residual_and_jacobian_parts(
            y, region, rock, coeffs, t0, t1, tangent_dtype=tangent_dtype
        )
        return r, L, fluxes, err, self.assemble_bsr(parts)

    def assemble_bsr(self, parts) -> bsr.BSRMatrix:
        """Scatter element-major block parts (diag2 [b*b,N], J[l,r]
        [b*b,F], J[r,l] [b*b,F]) into BSR data.

        Only needed off the banded fast path (ELL matvec, LU, FD
        validation): the Newton hot path keeps the parts form and packs
        bands directly (linear_operator_from_parts), skipping this
        scatter and the band gather it would feed."""
        from waiwera_tpu.solver.smallblocks import batch_from_em

        diag2, lr2, rl2 = parts
        return bsr.assemble(
            self.structure,
            batch_from_em(diag2),
            batch_from_em(lr2),
            batch_from_em(rl2),
            self.pos_lr,
            self.pos_rl,
        )

    def residual_and_jacobian_parts(
        self,
        y: Array,
        region: Array,
        rock: RockState,
        coeffs: MethodCoeffs,
        t0: Array,
        t1: Array,
        tangent_dtype=None,
    ):
        """residual_and_jacobian without the BSR scatter: returns
        (r, L, fluxes, err, (diag [N,b,b], J_lr [F,b,b], J_rl
        [F,b,b]))."""
        if tangent_dtype is not None:
            r, L, fluxes, err = self.residual(
                y, region, rock, coeffs, t0, t1
            )
            parts = self.jacobian_parts(
                y, region, rock, coeffs, t0, t1,
                tangent_dtype=tangent_dtype,
            )
            return r, L, fluxes, err, parts
        return self._rj_core(y, region, rock, coeffs, t0, t1)

    def jacobian_parts(
        self,
        y: Array,
        region: Array,
        rock: RockState,
        coeffs: MethodCoeffs,
        t0: Array,
        t1: Array,
        tangent_dtype=None,
    ):
        """Jacobian block parts ONLY — no separate residual evaluation.

        The Newton loop carries the residual from its post-linesearch
        recompute, so re-evaluating it at the same iterate inside the
        Jacobian call would duplicate the costliest f64 EOS chain.
        This is the counterpart of the reference's cached-balance reuse
        for its FD Jacobian (flow_simulation.F90:851-878,1429-1444).
        """
        if tangent_dtype is not None:
            import warnings

            with warnings.catch_warnings():
                warnings.filterwarnings(
                    "ignore", message=".*truncated to dtype float32.*"
                )
                with jax.enable_x64(False):
                    # nested jit: the f32 trace gets its own closed
                    # jaxpr, so shared numpy constants (thermo tables)
                    # don't alias the f64 residual trace's f64 avals
                    core32 = jax.jit(
                        lambda yy, rr, cc: self._rj_core(
                            yy, region, rr, cc, t0, t1,
                            mesh=self._mesh_cast(tangent_dtype),
                        )[4]
                    )
                    def cast(a):
                        if hasattr(a, "dtype") and jnp.issubdtype(
                            a.dtype, jnp.floating
                        ):
                            return a.astype(tangent_dtype)
                        return a

                    return core32(
                        y.astype(tangent_dtype),
                        jax.tree_util.tree_map(cast, rock),
                        jax.tree_util.tree_map(cast, coeffs),
                    )
        # f64 path: the residual shares most of its chain with the
        # primal linearization point, so XLA CSEs the overlap; unused
        # outputs are dead-code eliminated
        return self._rj_core(y, region, rock, coeffs, t0, t1)[4]

    def linear_operator_from_parts(
        self, parts, pc_name, dtype=None, sweeps=3
    ):
        """(matvec, preconditioner) straight from block parts.

        Banded meshes with a band plan: bands packed by
        reshape/pad (gather-free), diagonal factorisations from the
        diag part directly. Otherwise: assemble BSR and use
        make_linear_operator."""
        from waiwera_tpu.solver import precond as _precond
        from waiwera_tpu.solver.smallblocks import invert_blocks

        banded = self.dia is not None and self.band_plan is not None
        if (not banded and self.hybrid is None) or pc_name == "lu":
            return self.make_linear_operator(
                self.assemble_bsr(parts), pc_name, dtype=dtype,
                sweeps=sweeps,
            )
        from waiwera_tpu.solver.smallblocks import (
            apply_blocks_em,
            invert_blocks_em,
        )

        diag2, lr2, rl2 = parts
        # Pack in the parts' own dtype (f64 on the f64-Jacobian path)
        # so preconditioner FACTORISATIONS see full precision; only the
        # per-iteration APPLICATION runs in the reduced dtype — the
        # make_linear_operator contract (advisor r4 finding).
        if banded:
            m64 = dia.bands_from_blocks(
                self.dia, self.band_plan, diag2, lr2, rl2, None
            )
        else:
            synth_dia, synth_plan = self.hybrid
            m64 = dia.bands_from_blocks(
                synth_dia, synth_plan, diag2, lr2, rl2, None
            )
        m = (
            m64
            if dtype is None or m64.bands.dtype == dtype
            else m64._replace(bands=m64.bands.astype(dtype))
        )
        base_mv = m.matvec
        if banded or int(self._tail_cl.shape[0]) == 0:
            mv = base_mv
        else:
            # hybrid: tail blocks (MINC chains, irregular faces)
            # applied as small indexed gathers on top of the band SpMV
            fl_ = self.face_plan.f_live
            lr_t = lr2[:, fl_:]
            rl_t = rl2[:, fl_:]
            if dtype is not None:
                lr_t = lr_t.astype(dtype)
                rl_t = rl_t.astype(dtype)
            tcl = self._tail_cl
            tcr = self._tail_cr

            def mv(x):
                y = base_mv(x)
                xc = x.astype(lr_t.dtype)
                return (
                    y.at[tcl].add(apply_blocks_em(lr_t, xc[tcr]))
                    .at[tcr].add(apply_blocks_em(rl_t, xc[tcl]))
                )

        if pc_name in ("none",):
            pc = lambda r: r
        elif pc_name in ("bjacobi", "jacobi"):
            # invert in the parts' dtype (f64); cast the factors only
            dinv2 = invert_blocks_em(diag2)
            pc = dia.dia_block_jacobi_em(dinv2, dtype)
        elif pc_name in ("line", "zline"):
            # exact block-tridiagonal solve along the outermost band
            # (z lines): batched Thomas scans, factored in f64
            pc = dia.dia_line_pc_em(m64, dtype=dtype)
            if pc is None:
                dinv2 = invert_blocks_em(diag2)
                pc = dia.dia_block_jacobi_em(dinv2, dtype)
        elif pc_name in ("cpr", "cprmg"):
            # CPR: geometric multigrid V-cycle on the pressure block
            # + block-Jacobi correction (ops/mg.py). NON-DEFAULT:
            # fewer BiCGStab iterations than bjacobi on mild systems
            # (test_cpr_mg_preconditioner), but on late-Newton two-phase
            # Jacobians the Jacobi-smoothed aggregation V-cycle can
            # need more. bjacobi stays the default.
            from waiwera_tpu.ops import mg as ops_mg

            built = ops_mg.pressure_levels(m64, dtype=dtype)
            dinv2 = invert_blocks_em(diag2)
            bj = dia.dia_block_jacobi_em(dinv2, dtype)
            if built is None:
                pc = bj
            else:
                levels, dims = built
                pc = ops_mg.cpr_apply(
                    levels, dims, mv, bj, self.mesh.num_cells,
                    self.npv,
                )
        else:  # asm / ilu / dilu / sgs -> shift-based DILU
            # hybrid: the DILU factorisation ignores the tail blocks
            # (restricted to the banded part; the tail still enters
            # the matvec above). Factor from the full-precision bands.
            pc = dia.dia_dilu_em(m64, sweeps=sweeps, dtype=dtype)
        return mv, pc

    def _mesh_cast(self, dtype):
        """Mesh arrays with floating fields cast to dtype: keeps the
        f32 tangent chain from re-promoting to f64 through captured f64
        geometry.

        Deliberately NOT cached on self: a System instance outlives any
        single jit trace, and caching traced arrays across traces leaks
        tracers (the round-2 bench crash). The casts are pure astype
        ops, called at most once per trace, and XLA constant-folds them
        when the mesh leaves are concrete.
        """
        return jax.tree_util.tree_map(
            lambda a: (
                a.astype(dtype)
                if hasattr(a, "dtype")
                and jnp.issubdtype(a.dtype, jnp.floating)
                else a
            ),
            self.mesh,
        )

    def _rj_core(
        self,
        y: Array,
        region: Array,
        rock: RockState,
        coeffs: MethodCoeffs,
        t0: Array,
        t1: Array,
        mesh: Optional[MeshArrays] = None,
    ):
        if mesh is None:
            mesh = self.mesh
        npv = self.npv
        n = mesh.num_cells
        cl = mesh.face_cells[:, 0]
        cr = mesh.face_cells[:, 1]

        def derived_flat(yv):
            fluid, cond, _ = self.derived_state(yv, region, rock)
            if cond is None:
                cond = jnp.zeros(n)
            return fluid, cond

        # primal + npv cell-local tangents of the derived state.
        # jax.linearize evaluates the (expensive EOS) primal chain ONCE
        # and replays only the linear tangent ops per seed — npv
        # separate jax.jvp calls would re-evaluate the primal npv times.
        (fluid, cond0), derived_lin = jax.linearize(derived_flat, y)
        _, _, err = self.derived_state(y, region, rock)
        d_fluid = []
        d_cond = []
        for v in range(npv):
            seed = jnp.zeros_like(y).at[:, v].set(1.0)
            df, dc = derived_lin(seed)
            d_fluid.append(df)
            d_cond.append(dc)
        cond = None if self.isothermal else cond0

        # cell-local terms: L and sources
        def cell_fn(f):
            L = self.lhs(f, rock)
            q = self.source_term(f, t0, t1)
            return L, q

        (L, q), cell_lin = jax.linearize(cell_fn, fluid)
        dL = []
        dq = []
        for v in range(npv):
            dLv, dqv = cell_lin(d_fluid[v])
            dL.append(dLv)
            dq.append(dqv)

        # face fluxes and their side Jacobians (plan-based slicing
        # gathers when the face plan holds; indexed gathers otherwise)
        perm_l, perm_r = self._perm_sides(rock, mesh)
        if self.face_plan is not None:
            fl, fr = self.gather_face_sides(fluid)
            cdl = self._face_gather_leaf(cond0, False)
            cdr = self._face_gather_leaf(cond0, True)
        else:
            fl = assembly.gather_state(fluid, cl)
            fr = assembly.gather_state(fluid, cr)
            cdl = cond0[cl]
            cdr = cond0[cr]

        def flux_fn(f_l, f_r, c_l, c_r):
            return assembly.face_fluxes_pairs(
                f_l,
                f_r,
                perm_l,
                perm_r,
                None if self.isothermal else c_l,
                None if self.isothermal else c_r,
                mesh,
                npv,
                self.eos.num_mobile_phases,
                self.isothermal,
            )

        fluxes, flux_lin = jax.linearize(flux_fn, fl, fr, cdl, cdr)

        def _zero_tangent(a):
            # integer leaves (region, phase_composition) take float0
            # tangents under jvp/linearize
            if jnp.issubdtype(a.dtype, jnp.floating):
                return jnp.zeros_like(a)
            return np.zeros(a.shape, jax.dtypes.float0)

        zf = jax.tree_util.tree_map(_zero_tangent, fl)
        zc = jnp.zeros_like(cdl)
        if self.face_plan is not None:
            def side_gather(tree, right):
                return jax.tree_util.tree_map(
                    lambda a: self._face_gather_leaf(a, right), tree
                )
        else:
            def side_gather(tree, right):
                return assembly.gather_state(tree, cr if right else cl)
        dflux_l = []
        dflux_r = []
        for v in range(npv):
            dfl = side_gather(d_fluid[v], False)
            dcl = self._face_gather_leaf(d_cond[v], False) \
                if self.face_plan is not None else d_cond[v][cl]
            t = flux_lin(dfl, zf, dcl, zc)
            dflux_l.append(t[:, :npv])
            dfr = side_gather(d_fluid[v], True)
            dcr = self._face_gather_leaf(d_cond[v], True) \
                if self.face_plan is not None else d_cond[v][cr]
            t = flux_lin(zf, dfr, zc, dcr)
            dflux_r.append(t[:, :npv])

        # residual
        inflow = self._inflows(fluxes, mesh)
        R = inflow + q
        R = jnp.where(mesh.is_ghost[:, None], 0.0, R)
        r = coeffs.c_lhs * L + coeffs.const - coeffs.dt_eff * R
        r = jnp.where(mesh.is_ghost[:, None], 0.0, r)

        # -- assemble blocks, ELEMENT-MAJOR: parts are (diag2 [b*b,N],
        # lr2 [b*b,F], rl2 [b*b,F]) with the long axis last, so block
        # data lives as stacks of contiguous [N]/[F] vectors and the
        # band packing is slicing along that axis.
        # J[i,j][e,v] = dr_i[e]/dy_j[v], row e*npv+v of the stack.
        area = mesh.face_area
        vol = jnp.where(mesh.cell_volume > 0.0, mesh.cell_volume, 1.0)
        if self.face_plan is not None:
            vol_l = self._face_gather_leaf(vol, False)
            vol_r = self._face_gather_leaf(vol, True)
            ghost_l = self._face_gather_leaf(mesh.is_ghost, False)
            ghost_r = self._face_gather_leaf(mesh.is_ghost, True)
        else:
            vol_l = vol[cl]
            vol_r = vol[cr]
            ghost_l = mesh.is_ghost[cl]
            ghost_r = mesh.is_ghost[cr]
        av_l = area / vol_l  # [F]
        av_r = area / vol_r
        either_ghost = ghost_l | ghost_r

        # diagonal: cL dL - dt_eff dq + face self-terms
        diag2 = jnp.stack(
            [
                coeffs.c_lhs * dL[v][:, ii] - coeffs.dt_eff * dq[v][:, ii]
                for ii in range(npv)
                for v in range(npv)
            ]
        )  # [bb, N]
        contrib_l2 = jnp.stack(
            [
                jnp.where(
                    ghost_l, 0.0,
                    coeffs.dt_eff * av_l * dflux_l[v][:, ii],
                )
                for ii in range(npv)
                for v in range(npv)
            ]
        )  # [bb, F]
        contrib_r2 = jnp.stack(
            [
                jnp.where(
                    ghost_r, 0.0,
                    -coeffs.dt_eff * av_r * dflux_r[v][:, ii],
                )
                for ii in range(npv)
                for v in range(npv)
            ]
        )
        diag2 = diag2 + self.scatter_face_sides_em(
            contrib_l2, contrib_r2, mesh
        )
        # ghost rows: identity
        eye2 = jnp.eye(npv, dtype=diag2.dtype).reshape(-1)[:, None]
        diag2 = jnp.where(mesh.is_ghost[None, :], eye2, diag2)

        # off-diagonal blocks (zero if either end is ghost: ghost dofs
        # are fully decoupled)
        lr2 = jnp.stack(
            [
                jnp.where(
                    either_ghost, 0.0,
                    coeffs.dt_eff * av_l * dflux_r[v][:, ii],
                )
                for ii in range(npv)
                for v in range(npv)
            ]
        )
        rl2 = jnp.stack(
            [
                jnp.where(
                    either_ghost, 0.0,
                    -coeffs.dt_eff * av_r * dflux_l[v][:, ii],
                )
                for ii in range(npv)
                for v in range(npv)
            ]
        )

        return r, L, fluxes, err, (diag2, lr2, rl2)
