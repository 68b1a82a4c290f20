"""shard_map execution of the nonlinear timestep over a device mesh.

The single-device System/newton_solve/krylov stack runs unchanged on
domain-decomposed arrays: LocalSystem overrides the parallel hooks
(System.interior_mask/sync/reduce_*) with XLA collectives, and
DistributedSystem builds the per-device static data (local mesh, BSR
structure, halo routing) on host and wires the whole Newton step
through jax.shard_map.

Mapping to the reference: a device = an MPI rank; to_local =
DMGlobalToLocal scatter; sync = PetscSF halo exchange; the psum/pmax
reductions = the Vec norm / allreduce calls inside SNES/KSP
(dm_utils.F90:644, mpi_utils.F90:37-56).

Scope: the full Newton + Krylov + transitions step with the complete
source-network model (groups/reinjectors aggregate per-source cell
states via a psum, then run the tiny network DAG replicated on every
device — the analogue of the reference's MPI gathers in
source_network.F90:91-127). Preconditioners: bjacobi and the local
shift/split DILU, which with overlap-1 halos and identity halo rows
acts as restricted additive Schwarz — the reference's ASM/ILU0 default
(timestepper.F90:1743-1835). SpMV uses a hybrid layout: the owned-owned
couplings go through the banded DIA path when
the partition preserves bandedness, plus a thin gathered halo-edge
correction; unstructured partitions fall back to ELL.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh as DeviceMesh, NamedSharding, PartitionSpec as P

from waiwera_tpu.mesh.device import MeshArrays
from waiwera_tpu.ops import ell as ops_ell
from waiwera_tpu.parallel.partition import PartitionPlan, build_partition
from waiwera_tpu.physics.state import RockState
from waiwera_tpu.solver import bsr
from waiwera_tpu.solver.bsr import BSRStructure
from waiwera_tpu.solver.newton import NewtonParams, newton_solve
from waiwera_tpu.solver.system import MethodCoeffs, System, method_coeffs

Array = jnp.ndarray

AXIS = "part"


class LocalSystem(System):
    """System on one device's local cells (owned + halo), with the
    parallel hooks implemented as collectives over the mesh axis."""

    def __init__(
        self,
        eos,
        mesh_local: MeshArrays,
        network,
        structure: BSRStructure,
        ell_struct: ops_ell.ELLStructure,
        pos_lr: Array,
        pos_rl: Array,
        owned: Array,
        send_idx: Array,
        recv_src: Array,
        n_owned_pad: int,
        axis: str = AXIS,
        dia_struct=None,
        halo_rows: Optional[Array] = None,
        halo_cols: Optional[Array] = None,
        halo_pos: Optional[Array] = None,
        ilu_split=None,
        global_cells: Optional[Array] = None,
        p2p_perms=None,
        p2p_send: Optional[Array] = None,
        p2p_recv: Optional[Array] = None,
        face_plan=None,
        hybrid=None,
        tail_cl: Optional[Array] = None,
        tail_cr: Optional[Array] = None,
    ):
        # no super().__init__: structure is prebuilt per device on host
        self.eos = eos
        self.mesh = mesh_local
        self.network = network
        self.npv = eos.num_primary_variables
        self.isothermal = eos.isothermal
        self.structure = structure
        self.ell = ell_struct
        self.pos_lr = pos_lr
        self.pos_rl = pos_rl
        self.owned = owned
        self.send_idx = send_idx
        self.recv_src = recv_src
        self.n_owned_pad = n_owned_pad
        self.axis = axis
        self.dia = dia_struct
        self.halo_rows = halo_rows
        self.halo_cols = halo_cols
        self.halo_pos = halo_pos
        self.ilu_split = ilu_split
        self.global_cells = global_cells
        self.p2p_perms = p2p_perms
        self.p2p_send = p2p_send
        self.p2p_recv = p2p_recv
        # gather-free band packing / face plans: when every device's
        # canonically-ordered faces yield the SAME periodic-slice plan
        # (DistributedSystem detection), the banded-prefix pack and
        # plan-based face gathers run under shard_map exactly as on a
        # single device — the per-rank BAIJ efficiency of the
        # reference (ode.F90:266-287). Irregular partitions leave
        # these None and fall back to assemble_bsr + indexed gathers.
        self.band_plan = None
        self.face_plan = face_plan
        self.hybrid = hybrid
        if face_plan is not None:
            self._tail_cl = tail_cl
            self._tail_cr = tail_cr

    # -- parallel hooks ----------------------------------------------

    @property
    def interior_mask(self) -> Array:
        return self.owned & ~self.mesh.is_ghost

    @property
    def update_mask(self) -> Array:
        # halo copies of remote interior cells update locally (same
        # pure per-cell transition on synced inputs as on their owner)
        return ~self.mesh.is_ghost

    def reduce_sum(self, x: Array) -> Array:
        return lax.psum(x, self.axis)

    def reduce_max(self, x: Array) -> Array:
        return lax.pmax(x, self.axis)

    def reduce_any(self, x: Array) -> Array:
        return lax.pmax(x.astype(jnp.int32), self.axis) > 0

    def to_global_cell(self, cell: Array) -> Array:
        if self.global_cells is None:
            return cell
        return self.global_cells[cell]

    def sync(self, x):
        """Overlap-1 halo exchange (PetscSF DMGlobalToLocal analogue):
        point-to-point rounds of lax.ppermute over the edge-colored
        neighbour graph — each round every device sends at most one
        packed buffer to one neighbour and scatters what it received
        into its halo slots (pad entries index out of bounds and are
        dropped). O(rounds * S_edge) traffic where the old all_gather
        broadcast was O(D * S)."""
        if self.p2p_perms is None or self.p2p_send is None:
            def ex(a):
                send = a[self.send_idx]
                gathered = lax.all_gather(send, self.axis)  # [D, S, ..]
                flat = gathered.reshape((-1,) + a.shape[1:])
                halo = flat[self.recv_src]
                return a.at[self.n_owned_pad :].set(halo)

            return jax.tree_util.tree_map(ex, x)

        def ex(a):
            out = a
            for r, perm in enumerate(self.p2p_perms):
                buf = a[self.p2p_send[r]]
                rbuf = lax.ppermute(buf, self.axis, perm)
                out = out.at[self.p2p_recv[r]].set(rbuf, mode="drop")
            return out

        return jax.tree_util.tree_map(ex, x)

    def make_matvec(self, mat, dtype=None):
        if self.dia is not None:
            from waiwera_tpu.ops import dia as ops_dia

            m = ops_dia.to_dia(mat, self.dia, dtype)
            b = self.npv
            datap = jnp.concatenate(
                [mat.data, jnp.zeros((1, b, b), mat.data.dtype)], axis=0
            )
            hdata = datap[self.halo_pos]  # [H, b, b] (pad: zero)
            if dtype is not None:
                hdata = hdata.astype(dtype)

            def mv(x):
                # halo exchange overlapped with interior compute
                # (SURVEY §7.5-6): the DIA bands cover only owned-owned
                # couplings, so the banded matvec consumes the
                # *unsynced* x and has no data dependency on the
                # ppermute rounds — XLA schedules them concurrently.
                # Only the thin halo-edge correction (owned rows
                # coupled to halo columns, an O(N^(2/3)) surface term)
                # waits for the exchange.
                xs = self.sync(x)
                y = m.matvec(x)
                prod = jnp.einsum(
                    "kij,kj->ki", hdata,
                    xs[self.halo_cols].astype(hdata.dtype),
                    precision=lax.Precision.HIGHEST,
                )
                y = y.at[self.halo_rows].add(prod)
                return jnp.where(self.owned[:, None], y, 0.0)

            return mv

        m = ops_ell.to_ell(mat, self.ell, dtype)

        def mv(x):
            y = m.matvec(self.sync(x))
            return jnp.where(self.owned[:, None], y, 0.0)

        return mv

    def make_linear_operator(self, mat, pc_name, dtype=None, sweeps=3):
        """Distributed variant: hybrid DIA/ELL matvec with halo sync.

        The preconditioner acts on the local rows: bjacobi is exact
        block-Jacobi; asm/ilu/dilu/sgs run the local DILU/SGS, whose
        combination with overlap-1 halos and identity halo rows is a
        restricted additive Schwarz — the distributed analogue of the
        reference's ASM(overlap 1)+ILU(0) default
        (timestepper.F90:1743-1835)."""
        from waiwera_tpu.solver import precond as _precond

        mv = self.make_matvec(mat, dtype)
        if pc_name in ("bjacobi", "jacobi", "none", "line", "zline",
                       "cpr", "cprmg"):
            # line/CPR hierarchies are single-device structures;
            # distributed falls back to exact block-Jacobi
            pc = _precond.make_preconditioner(
                "none" if pc_name == "none" else "bjacobi",
                mat, sweeps=sweeps, dtype=dtype,
            )
        else:  # asm / ilu / dilu / sgs
            b = self.npv
            datap = jnp.concatenate(
                [mat.data, jnp.zeros((1, b, b), mat.data.dtype)], axis=0
            )
            matp = bsr.BSRMatrix(structure=self.structure, data=datap)
            pc = _precond.dilu(
                matp, self.ilu_split, sweeps=sweeps, dtype=dtype
            )
        return mv, pc

    # -- row masking: only owned rows count --------------------------

    def residual(self, y, region, rock, coeffs, t0, t1):
        r, L, fluxes, err = super().residual(y, region, rock, coeffs, t0, t1)
        r = jnp.where(self.owned[:, None], r, 0.0)
        return r, L, fluxes, err

    def _fix_parts(self, parts):
        """Halo/pad rows -> identity so the local preconditioner stays
        well-defined; their matvec output is masked anyway. Parts are
        element-major ([b*b, N] diag, [b*b, F] off-diagonals)."""
        diag2, lr2, rl2 = parts
        eye2 = jnp.eye(self.npv, dtype=diag2.dtype).reshape(-1)[:, None]
        diag2 = jnp.where(self.owned[None, :], diag2, eye2)
        cl = self.mesh.face_cells[:, 0]
        cr = self.mesh.face_cells[:, 1]
        zero = jnp.zeros((), lr2.dtype)
        lr2 = jnp.where(self.owned[cl][None, :], lr2, zero)
        rl2 = jnp.where(self.owned[cr][None, :], rl2, zero)
        return diag2, lr2, rl2

    def residual_and_jacobian_parts(
        self, y, region, rock, coeffs, t0, t1, tangent_dtype=None
    ):
        r, L, fluxes, err, parts = super().residual_and_jacobian_parts(
            y, region, rock, coeffs, t0, t1, tangent_dtype=tangent_dtype
        )
        r = jnp.where(self.owned[:, None], r, 0.0)
        return r, L, fluxes, err, self._fix_parts(parts)

    def jacobian_parts(
        self, y, region, rock, coeffs, t0, t1, tangent_dtype=None
    ):
        return self._fix_parts(
            super().jacobian_parts(
                y, region, rock, coeffs, t0, t1,
                tangent_dtype=tangent_dtype,
            )
        )

    def linear_operator_from_parts(
        self, parts, pc_name, dtype=None, sweeps=3
    ):
        """Distributed gather-free fast path: with a common face plan,
        the owned-owned Jacobian blocks pack straight into DIA bands by
        reshape/pad and the matvec is band-shifts + a thin indexed tail
        (cross-device halo edges, ghost faces). The halo exchange has
        no data dependency on the band SpMV, so XLA overlaps them
        (SURVEY §7.5-6). Falls back to assemble_bsr otherwise."""
        if self.hybrid is None or self.face_plan is None or pc_name == "lu":
            return self.make_linear_operator(
                self.assemble_bsr(parts), pc_name,
                dtype=dtype, sweeps=sweeps,
            )
        from waiwera_tpu.ops import dia as ops_dia
        from waiwera_tpu.solver.smallblocks import (
            apply_blocks_em,
            invert_blocks_em,
        )

        diag2, lr2, rl2 = parts
        synth_dia, synth_plan = self.hybrid
        # pack in the parts' dtype (f64): factorisations see full
        # precision, applications run in `dtype`
        m64 = ops_dia.bands_from_blocks(
            synth_dia, synth_plan, diag2, lr2, rl2, None
        )
        m = (
            m64
            if dtype is None or m64.bands.dtype == dtype
            else m64._replace(bands=m64.bands.astype(dtype))
        )
        base_mv = m.matvec
        fl_ = self.face_plan.f_live
        lr_t = lr2[:, fl_:]
        rl_t = rl2[:, fl_:]
        if dtype is not None:
            lr_t = lr_t.astype(dtype)
            rl_t = rl_t.astype(dtype)
        tcl = self._tail_cl
        tcr = self._tail_cr

        def mv(x):
            # bands cover only owned-owned couplings, so the band SpMV
            # consumes the UNSYNCED x while the ppermute rounds run;
            # only the tail correction waits for the exchange
            xs = self.sync(x)
            y = base_mv(x)
            xc = xs.astype(lr_t.dtype)
            y = (
                y.at[tcl].add(apply_blocks_em(lr_t, xc[tcr]))
                .at[tcr].add(apply_blocks_em(rl_t, xc[tcl]))
            )
            return jnp.where(self.owned[:, None], y, 0.0)

        if pc_name in ("none",):
            pc = lambda r: r
        elif pc_name in ("bjacobi", "jacobi", "line", "zline", "cpr",
                         "cprmg"):
            # line/CPR hierarchies are single-device structures;
            # distributed falls back to exact block-Jacobi
            dinv2 = invert_blocks_em(diag2)
            pc = ops_dia.dia_block_jacobi_em(dinv2, dtype)
        else:  # asm / ilu / dilu / sgs -> local DILU == restricted
            # additive Schwarz with the overlap-1 halos (identity halo
            # rows from _fix_parts keep the factorisation well-defined)
            pc = ops_dia.dia_dilu_em(m64, sweeps=sweeps, dtype=dtype)
        return mv, pc


class _LocalSources:
    """Per-device view of a replicated source network: cell indices
    remapped to local slots, rates masked to the owning device so each
    source is applied exactly once.

    Groups/reinjectors aggregate flows across sources that may live on
    different devices: each device gathers the cell state of its owned
    sources, a psum replicates the full per-source state, and the tiny
    network DAG then runs identically (replicated) on every device —
    the shard_map analogue of the reference's MPI reductions in
    source_network.F90:91-127."""

    def __init__(self, base, cell_local, owner_mask, axis=AXIS):
        self.base = copy.copy(base)
        self.base.arrays = base.arrays._replace(cell=cell_local)
        self.arrays = self.base.arrays
        self.num_sources = base.num_sources
        self.owner_mask = owner_mask
        self.axis = axis

    def flows(self, fluid, t0, t1):
        from waiwera_tpu.sim.sources import gather_cell_state

        state = gather_cell_state(fluid, self.arrays.cell)
        if self.base.has_network:
            # replicate the true per-source state everywhere (each
            # source owned exactly once, so masked psum == gather)
            mask = self.owner_mask

            def rep(a):
                m = mask.reshape(mask.shape + (1,) * (a.ndim - 1))
                return lax.psum(jnp.where(m, a, 0.0), self.axis)

            state = jax.tree_util.tree_map(rep, state)
        rate, enthalpy = self.base.flows_from_state(state, t0, t1)
        return jnp.where(self.owner_mask, rate, 0.0), enthalpy

    def tracer_injection(self, t0, t1):
        inj = self.base.tracer_injection(t0, t1)
        return jnp.where(self.owner_mask[:, None], inj, 0.0)


class DistributedSystem:
    """Host-side builder: partitions a Simulation over a device mesh
    and provides local<->global transfer plus the shard_mapped step."""

    def __init__(self, sim, num_devices: int, devices=None):
        self.sim = sim
        self.plan: PartitionPlan = build_partition(sim.mesh, num_devices)
        self.num_devices = num_devices
        if devices is None:
            avail = jax.devices()
            if len(avail) < num_devices:
                raise ValueError(
                    f"DistributedSystem needs {num_devices} devices "
                    f"but only {len(avail)} are available "
                    f"(on CPU set jax_num_cpu_devices or "
                    f"--xla_force_host_platform_device_count before "
                    f"backend initialisation)"
                )
            devices = avail[:num_devices]
        elif len(devices) < num_devices:
            raise ValueError(
                f"DistributedSystem given {len(devices)} devices, "
                f"needs {num_devices}"
            )
        self.device_mesh = DeviceMesh(np.array(devices), (AXIS,))
        self.sharding = NamedSharding(self.device_mesh, P(AXIS))

        plan = self.plan
        D = num_devices
        mesh = sim.mesh
        npv = sim.eos.num_primary_variables

        # --- stacked local mesh arrays [D, ...] ----------------------
        fid = plan.face_ids
        fmask = plan.face_mask
        fflip = plan.face_flip
        area = np.asarray(mesh.face_area)[fid] * fmask
        dist = np.asarray(mesh.face_distance)[fid]
        dist12 = np.where(fmask, np.asarray(mesh.face_distance12)[fid], 1.0)
        dist = np.where(fmask[..., None], dist, 0.5)
        gnorm = np.asarray(mesh.face_gravity_normal)[fid] * fmask
        pdir = np.asarray(mesh.face_permeability_direction)[fid] * fmask
        # canonical per-device orientation (partition.py face_flip):
        # swap per-side distances + negate the signed gravity normal —
        # the flux kernel is exactly invariant (mesh.device)
        dist = np.where(fflip[..., None], dist[..., ::-1], dist)
        gnorm = np.where(fflip, -gnorm, gnorm)
        lc = plan.local_cells
        vol = np.asarray(mesh.cell_volume)[lc]
        ghost = np.asarray(mesh.is_ghost)[lc]

        self._mesh_static = dict(
            face_cells=jnp.asarray(plan.face_cells_local, jnp.int32),
            face_area=jnp.asarray(area),
            face_distance=jnp.asarray(dist),
            face_distance12=jnp.asarray(dist12),
            face_gravity_normal=jnp.asarray(gnorm),
            face_permeability_direction=jnp.asarray(pdir, jnp.int32),
            cell_volume=jnp.asarray(vol),
            is_ghost=jnp.asarray(ghost),
        )

        # --- per-device BSR structures, padded to common nnzb --------
        structs = []
        positions = []
        for d in range(D):
            fc = plan.face_cells_local[d]
            st = bsr.build_structure(plan.n_local, fc, npv)
            lr, rl = bsr.face_block_positions(st, fc)
            structs.append(st)
            positions.append((lr, rl))
        nnzb = max(int(s.indices.shape[0]) for s in structs)
        # common ELL width across devices (scatter-free SpMV)
        ell_width = max(
            int(np.diff(np.asarray(s.indptr)).max()) for s in structs
        )
        rows = np.zeros((D, nnzb), np.int32)
        # pad cols != pad rows so padded entries never look like
        # diagonal blocks in the ghost-row fixup (they stay zero)
        cols = np.full((D, nnzb), min(1, plan.n_local - 1), np.int32)
        diag_pos = np.zeros((D, plan.n_local), np.int32)
        pos_lr = np.zeros((D,) + plan.face_cells_local.shape[1:2], np.int32)
        pos_rl = np.zeros_like(pos_lr)
        ell_indices = np.zeros((D, plan.n_local, ell_width), np.int32)
        ell_pos = np.zeros_like(ell_indices)
        for d, st in enumerate(structs):
            k = int(st.indices.shape[0])
            rows[d, :k] = np.asarray(st.rows)
            cols[d, :k] = np.asarray(st.indices)
            # pad entries: duplicate diag key of row 0; never written
            diag_pos[d] = np.asarray(st.diag_pos)
            pos_lr[d], pos_rl[d] = positions[d]
            es = ops_ell.ell_structure(st, width=ell_width)
            ell_indices[d] = np.asarray(es.indices)
            # pad sentinel (this device's nnzb) lands in the
            # zero-padded tail of the common-size data array
            ell_pos[d] = np.asarray(es.gather_pos)
        self._bsr_static = dict(
            rows=jnp.asarray(rows),
            cols=jnp.asarray(cols),
            diag_pos=jnp.asarray(diag_pos),
            pos_lr=jnp.asarray(pos_lr),
            pos_rl=jnp.asarray(pos_rl),
            ell_indices=jnp.asarray(ell_indices),
            ell_pos=jnp.asarray(ell_pos),
        )
        self._nnzb = nnzb
        self._ell_width = ell_width

        # --- ILU(0) lower/upper split (distributed DILU = restricted
        # additive Schwarz with the overlap-1 halos), padded to common
        # counts; sentinel positions point at the appended zero block
        lows, ups = [], []
        for d, st in enumerate(structs):
            r = np.asarray(st.rows)
            c = np.asarray(st.indices)
            k = len(r)
            key = r.astype(np.int64) * plan.n_local + c
            low = np.nonzero(c < r)[0]
            up = np.nonzero(c > r)[0]
            # transposed position (j,i) for each lower (i,j)
            want = c[low].astype(np.int64) * plan.n_local + r[low]
            trans = np.searchsorted(key, want)
            lows.append((low, r[low], c[low], trans))
            ups.append((up, r[up], c[up]))
        nl = max((len(x[0]) for x in lows), default=0) or 1
        nu = max((len(x[0]) for x in ups), default=0) or 1
        lp = np.full((D, nl), nnzb, np.int64)
        lr_ = np.zeros((D, nl), np.int64)
        lc_ = np.zeros((D, nl), np.int64)
        lt = np.full((D, nl), nnzb, np.int64)
        up_ = np.full((D, nu), nnzb, np.int64)
        ur_ = np.zeros((D, nu), np.int64)
        uc_ = np.zeros((D, nu), np.int64)
        for d in range(D):
            low, r_l, c_l, trans = lows[d]
            up, r_u, c_u = ups[d]
            lp[d, : len(low)] = low
            lr_[d, : len(low)] = r_l
            lc_[d, : len(low)] = c_l
            lt[d, : len(low)] = trans
            up_[d, : len(up)] = up
            ur_[d, : len(up)] = r_u
            uc_[d, : len(up)] = c_u
        self._bsr_static.update(
            ilu_lower_pos=jnp.asarray(lp, jnp.int32),
            ilu_lower_rows=jnp.asarray(lr_, jnp.int32),
            ilu_lower_cols=jnp.asarray(lc_, jnp.int32),
            ilu_lower_trans=jnp.asarray(lt, jnp.int32),
            ilu_upper_pos=jnp.asarray(up_, jnp.int32),
            ilu_upper_rows=jnp.asarray(ur_, jnp.int32),
            ilu_upper_cols=jnp.asarray(uc_, jnp.int32),
        )

        # --- hybrid banded SpMV: owned-owned couplings as DIA bands
        # + a thin gathered halo-edge correction.
        # Band offsets must be identical (static) across devices; take
        # the union, falling back to ELL if it exceeds the band cap.
        from waiwera_tpu.ops import dia as ops_dia

        ghost_loc = np.asarray(ghost)  # [D, n_local]
        off_union = set()
        lives, halo_sels = [], []
        for d, st in enumerate(structs):
            r = np.asarray(st.rows)
            c = np.asarray(st.indices)
            gl = ghost_loc[d][r]
            gc = ghost_loc[d][c]
            inner = (r < plan.n_owned_pad) & (c < plan.n_owned_pad)
            live = ((r == c) | ~(gl | gc)) & inner
            halo_sel = (
                ~(gl | gc)
                & (r < plan.n_owned_pad)
                & (c >= plan.n_owned_pad)
            )
            lives.append(live)
            halo_sels.append(halo_sel)
            off_union.update(
                np.unique(c[live].astype(np.int64) - r[live]).tolist()
            )
        if len(off_union) <= ops_dia.MAX_BANDS:
            offs = np.array(sorted(off_union), np.int64)
            band_pos = np.full(
                (D, len(offs), plan.n_local), nnzb, np.int64
            )
            for d, st in enumerate(structs):
                r = np.asarray(st.rows)
                c = np.asarray(st.indices)
                idx = np.nonzero(lives[d])[0]
                k = np.searchsorted(
                    offs, c[idx].astype(np.int64) - r[idx]
                )
                band_pos[d, k, r[idx]] = idx
            nh = max((int(h.sum()) for h in halo_sels), default=0) or 1
            h_rows = np.zeros((D, nh), np.int64)
            h_cols = np.zeros((D, nh), np.int64)
            h_pos = np.full((D, nh), nnzb, np.int64)
            for d, st in enumerate(structs):
                idx = np.nonzero(halo_sels[d])[0]
                h_rows[d, : len(idx)] = np.asarray(st.rows)[idx]
                h_cols[d, : len(idx)] = np.asarray(st.indices)[idx]
                h_pos[d, : len(idx)] = idx
            self._dia_offsets = tuple(int(o) for o in offs)
            self._bsr_static.update(
                dia_band_pos=jnp.asarray(band_pos, jnp.int32),
                halo_rows=jnp.asarray(h_rows, jnp.int32),
                halo_cols=jnp.asarray(h_cols, jnp.int32),
                halo_pos=jnp.asarray(h_pos, jnp.int32),
            )
        else:
            self._dia_offsets = None

        # --- gather-free band/face plan (distributed fast path) ------
        # build_partition orders each device's faces canonically
        # (banded owned-owned prefix, indexed tail); when every device
        # yields the SAME periodic-slice plan — uniform partitions of
        # rectilinear meshes, the production geometry — the plan is a
        # static constant under shard_map and the local Jacobian packs
        # into DIA bands by reshape/pad with NO BSR scatter+gather
        # round-trip, matching the single-device fast path.
        # Halo-like slots are passed as "ghost" so owned->halo
        # couplings stay OUT of the bands: the band SpMV then has no
        # dependency on the halo exchange (overlap preserved).
        from waiwera_tpu.ops import dia as ops_dia

        halo_like = np.zeros(plan.n_local, bool)
        halo_like[plan.n_owned_pad :] = True
        fplans = []
        for d in range(D):
            fp = ops_dia.face_plan_direct(
                plan.face_cells_local[d],
                ghost_loc[d] | halo_like,
                plan.n_local,
            )
            fplans.append(fp)
        self._face_plan_common = None
        self._hybrid_common = None
        if fplans[0] is not None and all(
            f == fplans[0] for f in fplans[1:]
        ):
            self._face_plan_common = fplans[0]
            self._hybrid_common = ops_dia.hybrid_band_structures(
                fplans[0], plan.n_local, npv
            )
            fl_ = fplans[0].f_live
            self._bsr_static.update(
                tail_cl=jnp.asarray(
                    plan.face_cells_local[:, fl_:, 0], jnp.int32
                ),
                tail_cr=jnp.asarray(
                    plan.face_cells_local[:, fl_:, 1], jnp.int32
                ),
            )

        # --- routing tables ------------------------------------------
        self._route_static = dict(
            owned=jnp.asarray(plan.owned_mask),
            send_idx=jnp.asarray(plan.send_idx, jnp.int32),
            recv_src=jnp.asarray(plan.recv_src, jnp.int32),
            p2p_send=jnp.asarray(plan.p2p_send, jnp.int32),
            p2p_recv=jnp.asarray(plan.p2p_recv, jnp.int32),
            # local slot -> global/natural cell index (AO analogue) for
            # observability: worst-cell reporting in natural order
            global_cells=jnp.asarray(plan.local_cells, jnp.int32),
        )
        self._p2p_perms = plan.p2p_perms

        # --- rock + sources ------------------------------------------
        self._rock_local = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)[lc]), sim.rock
        )
        network = getattr(sim, "sources", None)
        if network is not None and network.num_sources == 0:
            network = None
        self._network = network
        if network is not None:
            src_cells = np.asarray(network.arrays.cell)
            owner = plan.cell_device[src_cells]  # [ns]
            slot = plan.cell_slot[src_cells]
            # on each device: local slot if owned here, else slot 0
            cell_local = np.where(
                owner[None, :] == np.arange(D)[:, None], slot[None, :], 0
            )
            self._src_static = dict(
                src_cell_local=jnp.asarray(cell_local, jnp.int32),
                src_owner_mask=jnp.asarray(
                    owner[None, :] == np.arange(D)[:, None]
                ),
            )
        else:
            self._src_static = None

        # shard all stacked arrays over the device mesh
        put = lambda t: jax.device_put(t, self.sharding)
        self._mesh_static = jax.tree_util.tree_map(put, self._mesh_static)
        self._bsr_static = jax.tree_util.tree_map(put, self._bsr_static)
        self._route_static = jax.tree_util.tree_map(put, self._route_static)
        self._rock_local = jax.tree_util.tree_map(put, self._rock_local)
        if self._src_static is not None:
            self._src_static = jax.tree_util.tree_map(put, self._src_static)

    # -- global <-> local transfers -----------------------------------

    def to_local(self, x):
        """Gather global [N, ...] arrays into stacked local [D, n_local,
        ...] arrays (DMGlobalToLocal with overlap-1 halo)."""

        def g(a):
            return jax.device_put(
                jnp.asarray(np.asarray(a)[self.plan.local_cells]),
                self.sharding,
            )

        return jax.tree_util.tree_map(g, x)

    def from_local(self, x):
        """Scatter owned rows of stacked local arrays back to global
        natural order (for I/O; LocalToGlobal)."""
        plan = self.plan

        def s(a):
            a = np.asarray(a)
            n = plan.cell_device.shape[0]
            out = np.zeros((n,) + a.shape[2:], a.dtype)
            out[:] = a[plan.cell_device, plan.cell_slot]
            return out

        return jax.tree_util.tree_map(s, x)

    # -- the shard_mapped step ----------------------------------------

    def _local_system(self, mesh_st, bsr_st, route_st, src_st):
        mesh_local = MeshArrays(
            face_cells=mesh_st["face_cells"],
            face_area=mesh_st["face_area"],
            face_distance=mesh_st["face_distance"],
            face_distance12=mesh_st["face_distance12"],
            face_gravity_normal=mesh_st["face_gravity_normal"],
            face_permeability_direction=mesh_st[
                "face_permeability_direction"
            ],
            cell_volume=mesh_st["cell_volume"],
            is_ghost=mesh_st["is_ghost"],
            num_cells=self.plan.n_local,
            num_interior_cells=self.plan.n_local,
        )
        npv = self.sim.eos.num_primary_variables
        structure = BSRStructure(
            indptr=None,
            indices=bsr_st["cols"],
            rows=bsr_st["rows"],
            diag_pos=bsr_st["diag_pos"],
            num_rows=self.plan.n_local,
            block_size=npv,
        )
        ell_struct = ops_ell.ELLStructure(
            indices=bsr_st["ell_indices"],
            gather_pos=bsr_st["ell_pos"],
            num_rows=self.plan.n_local,
            block_size=npv,
            width=self._ell_width,
        )
        network = None
        if self._network is not None:
            network = _LocalSources(
                self._network,
                src_st["src_cell_local"],
                src_st["src_owner_mask"],
            )
        dia_struct = None
        halo_rows = halo_cols = halo_pos = None
        if self._dia_offsets is not None:
            from waiwera_tpu.ops import dia as ops_dia

            dia_struct = ops_dia.DIAStructure(
                offsets=self._dia_offsets,
                band_pos=bsr_st["dia_band_pos"],
                num_rows=self.plan.n_local,
                block_size=npv,
            )
            halo_rows = bsr_st["halo_rows"]
            halo_cols = bsr_st["halo_cols"]
            halo_pos = bsr_st["halo_pos"]
        from waiwera_tpu.solver.precond import ILU0Data

        ilu_split = ILU0Data(
            lower_pos=bsr_st["ilu_lower_pos"],
            lower_rows=bsr_st["ilu_lower_rows"],
            lower_cols=bsr_st["ilu_lower_cols"],
            upper_pos=bsr_st["ilu_upper_pos"],
            upper_rows=bsr_st["ilu_upper_rows"],
            upper_cols=bsr_st["ilu_upper_cols"],
            lower_trans_pos=bsr_st["ilu_lower_trans"],
        )
        return LocalSystem(
            self.sim.eos,
            mesh_local,
            network,
            structure,
            ell_struct,
            bsr_st["pos_lr"],
            bsr_st["pos_rl"],
            route_st["owned"],
            route_st["send_idx"],
            route_st["recv_src"],
            self.plan.n_owned_pad,
            dia_struct=dia_struct,
            halo_rows=halo_rows,
            halo_cols=halo_cols,
            halo_pos=halo_pos,
            ilu_split=ilu_split,
            global_cells=route_st.get("global_cells"),
            p2p_perms=self._p2p_perms,
            p2p_send=route_st.get("p2p_send"),
            p2p_recv=route_st.get("p2p_recv"),
            face_plan=self._face_plan_common,
            hybrid=self._hybrid_common,
            tail_cl=bsr_st.get("tail_cl"),
            tail_cr=bsr_st.get("tail_cr"),
        )

    def make_step_fn(
        self, newton_params: NewtonParams, method: str = "beuler"
    ):
        """Distributed analogue of Simulation.make_step_fn: same traced
        signature, but all cell arrays are stacked local [D, n_local,
        ...] (use to_local/from_local to convert)."""
        sim = self.sim

        loc = P(AXIS)
        rep = P()

        statics = (
            self._mesh_static,
            self._bsr_static,
            self._route_static,
            self._src_static,
            self._rock_local,
        )
        statics_specs = jax.tree_util.tree_map(lambda _: loc, statics)

        def local_step_core(
            mesh_st, bsr_st, route_st, src_st, rock, y, region,
            temperature, lhs_last, lhs_last2, t_last, dt, dt_last,
            first, fluid_last=None, fluxes_last=None,
        ):
            # shard_map blocks carry a leading device axis of size 1
            sq = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
            mesh_st, bsr_st, route_st, rock = (
                sq(mesh_st), sq(bsr_st), sq(route_st), sq(rock),
            )
            if src_st is not None:
                src_st = sq(src_st)
            y, region, temperature, lhs_last, lhs_last2 = (
                y[0], region[0], temperature[0], lhs_last[0], lhs_last2[0],
            )
            system = self._local_system(mesh_st, bsr_st, route_st, src_st)

            t0 = t_last
            t1 = t_last + dt
            coeffs = method_coeffs(
                method, dt, dt_last, first, lhs_last, lhs_last2
            )
            initial = None
            if fluid_last is not None and fluxes_last is not None:
                initial = (sq(fluid_last), lhs_last, fluxes_last[0])
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
            # final-iterate state carried out of the Newton loop (no
            # post-solve EOS re-evaluation), same as the single-device
            # step wrapper
            fluid, lhs_new, fluxes = res.fluid, res.lhs, res.fluxes
            res = res._replace(fluid=None, lhs=None, fluxes=None)
            ex = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)
            return ex(res), ex(fluid), ex(lhs_new), ex(fluxes)

        def local_step(*args):
            return local_step_core(*args)

        def local_step_fast(*args):
            *base, fluid_last, fluxes_last = args
            return local_step_core(
                *base, fluid_last=fluid_last, fluxes_last=fluxes_last
            )

        from waiwera_tpu.solver.newton import NewtonResult

        out_res_spec = NewtonResult(
            y=loc, region=loc, iterations=loc, converged=loc,
            failed=loc, max_residual=loc, linear_iterations=loc,
            worst_cell=loc, worst_equation=loc,
            fluid=None, lhs=None, fluxes=None,
        )

        base_in_specs = statics_specs + (
            loc, loc, loc, loc, loc, rep, rep, rep, rep,
        )
        mapped = jax.shard_map(
            local_step,
            mesh=self.device_mesh,
            in_specs=base_in_specs,
            out_specs=(out_res_spec, loc, loc, loc),
            check_vma=False,
        )
        mapped_fast = jax.shard_map(
            local_step_fast,
            mesh=self.device_mesh,
            in_specs=base_in_specs + (loc, loc),
            out_specs=(out_res_spec, loc, loc, loc),
            check_vma=False,
        )

        @jax.jit
        def step(y, region, temperature, lhs_last, lhs_last2, t_last, dt,
                 dt_last, first, rock_in=None, fluid_last=None,
                 fluxes_last=None):
            # rock_in: stacked-local time-varying rock (rock controls);
            # its presence invalidates the carried-state initial
            # residual (fluid_last/fluxes_last were computed under a
            # different rock), so the fast path is skipped
            st = (
                statics
                if rock_in is None
                else statics[:4] + (rock_in,)
            )
            common = (
                y, region, temperature, lhs_last, lhs_last2,
                t_last, dt, dt_last, first,
            )
            if (
                rock_in is None
                and fluid_last is not None
                and fluxes_last is not None
            ):
                res, fluid, lhs_new, fluxes = mapped_fast(
                    *st, *common, fluid_last, fluxes_last
                )
            else:
                res, fluid, lhs_new, fluxes = mapped(*st, *common)
            # scalar diagnostics are replicated; take device 0's copy
            res = res._replace(
                iterations=res.iterations[0],
                converged=res.converged[0],
                failed=res.failed[0],
                max_residual=res.max_residual[0],
                linear_iterations=res.linear_iterations[0],
                worst_cell=res.worst_cell[0],
                worst_equation=res.worst_equation[0],
            )
            return res, fluid, lhs_new, fluxes

        return step


class DistributedSimulation:
    """Drop-in replacement for Simulation in the Timestepper/CLI: the
    production multi-device path. All per-cell state is stacked local
    [D, n_local, ...]; the Timestepper's step/tracer functions run
    shard_mapped over the device mesh, and to_global() restores natural
    cell order for HDF5 output and source post-processing (the AO
    analogue, dm_utils.F90:782-841).

    The reference runs the same executable under mpiexec (run.rst:
    140-144); here the JSON config or CLI selects the device count and
    everything else — adaptive stepping, retry ladder, checkpoints,
    tracer aux solves, source networks, HDF5 output/restart — behaves
    identically to the single-device path.
    """

    def __init__(self, sim, num_devices: int, devices=None):
        from types import SimpleNamespace

        self.base = sim
        self.config = sim.config
        self.eos = sim.eos
        self.mesh = sim.mesh
        self.tracers = sim.tracers
        self.sources = sim.sources
        self.dist = DistributedSystem(sim, num_devices, devices=devices)
        d = self.dist
        self.rock = d._rock_local
        self.rock_controls = getattr(sim, "rock_controls", [])
        self.y0 = d.to_local(sim.y0)
        self.region0 = d.to_local(sim.region0)
        # halo/pad rows count as ghost for error/interior masks: each
        # cell's EOS errors are checked on its owning device only
        ghost_eff = (
            np.asarray(sim.mesh.is_ghost)[d.plan.local_cells]
            | ~d.plan.owned_mask
        )
        self.mesh_dev = SimpleNamespace(
            is_ghost=jax.device_put(jnp.asarray(ghost_eff), d.sharding)
        )

    # -- Timestepper interface -----------------------------------------

    def make_step_fn(self, newton_params, method="beuler"):
        return self.dist.make_step_fn(newton_params, method)

    def rock_for(self, t: float):
        """Stacked-local rock at time t (rock controls); the base
        simulation's rock when no controls exist."""
        if not self.rock_controls:
            return self.rock
        return self.dist.to_local(self.base.rock_for(t))

    def to_global(self, tree):
        """Stacked local -> natural-order global (numpy); the AO
        natural-ordering restore for I/O."""
        return self.dist.from_local(tree)

    def flux_to_global(self, fluxes):
        """Stacked local face fluxes [D, f_local, nf] -> global natural
        face order [F, nf] (faces replicated on two devices carry the
        same value; either copy wins)."""
        plan = self.dist.plan
        a = np.asarray(fluxes)
        out = np.zeros(
            (self.mesh.num_faces,) + a.shape[2:], a.dtype
        )
        for d in range(plan.num_devices):
            m = plan.face_mask[d]
            # flipped faces carry the flux in the local canonical
            # orientation; negate back to the host convention
            sign = np.where(plan.face_flip[d][m], -1.0, 1.0)
            out[plan.face_ids[d][m]] = a[d][m] * sign[
                (...,) + (None,) * (a.ndim - 2)
            ]
        return out

    def fluxes_at(self, y, region):
        """Initial-output fluxes: evaluated globally on host (init-time
        only), natural face order."""
        yg = jnp.asarray(self.dist.from_local(y))
        rg = jnp.asarray(self.dist.from_local(region))
        return np.asarray(self.base.fluxes_at(yg, rg))

    def dof_statistics(self) -> dict:
        """Per-device DOF distribution + Kumar imbalance
        (flow_simulation.F90:2998-3019): interior (non-boundary-ghost)
        owned cells per device times unknowns/cell. banded: whether
        every device packs its Jacobian by the common gather-free band
        plan."""
        plan = self.dist.plan
        is_ghost = np.asarray(self.base.mesh.is_ghost, bool)
        owned_interior = np.array([
            int(np.sum(~is_ghost[
                plan.local_cells[d][plan.owned_mask[d]]
            ]))
            for d in range(plan.num_devices)
        ])
        npv = self.eos.num_primary_variables
        dmin = int(owned_interior.min()) * npv
        dmax = int(owned_interior.max()) * npv
        return {
            "total": int(owned_interior.sum()) * npv,
            "min": dmin,
            "max": dmax,
            "imbalance": (dmax - dmin) / dmin if dmin else 0.0,
            "banded": (
                self.dist._face_plan_common is not None
                and self.dist._hybrid_common is not None
            ),
        }

    def lhs_at(self, y, region):
        """Initial balances: evaluated globally on host (init-time
        only), then scattered to the device mesh."""
        yg = jnp.asarray(self.dist.from_local(y))
        rg = jnp.asarray(self.dist.from_local(region))
        lhs, fluid, err = self.base.lhs_at(yg, rg)
        return (
            self.dist.to_local(lhs),
            self.dist.to_local(fluid),
            self.dist.to_local(err),
        )

    def initial_tracer_state(self):
        x0, al0 = self.base.initial_tracer_state()
        return self.dist.to_local(x0), self.dist.to_local(al0)

    def initial_fluxes(self, y, region):
        """Stacked-local face fluxes [D, F_local, nf] at an initial
        state — seeds the carried-state fast path (same face order the
        distributed step function returns)."""
        d = self.dist
        loc = P(AXIS)
        statics = (
            d._mesh_static, d._bsr_static, d._route_static,
            d._src_static, d._rock_local,
        )
        statics_specs = jax.tree_util.tree_map(lambda _: loc, statics)

        def local_fx(mesh_st, bsr_st, route_st, src_st, rock, y, region):
            sq = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
            mesh_st, bsr_st, route_st, rock = (
                sq(mesh_st), sq(bsr_st), sq(route_st), sq(rock),
            )
            if src_st is not None:
                src_st = sq(src_st)
            system = d._local_system(mesh_st, bsr_st, route_st, src_st)
            fluid, cond, _ = system.derived_state(
                y[0], region[0], rock
            )
            return system.fluxes(fluid, cond, rock)[None]

        mapped = jax.shard_map(
            local_fx,
            mesh=d.device_mesh,
            in_specs=statics_specs + (loc, loc),
            out_specs=loc,
            check_vma=False,
        )
        return jax.jit(mapped)(*statics, y, region)

    def make_tracer_step_fn(self):
        """Distributed auxiliary tracer solve: local advection/
        diffusion stencils with halo sync inside the matvec, psum'd
        dot products, owned-row masking (the parallel analogue of the
        reference's aux KSP gmres+bjacobi, timestepper.F90:1840-1851)."""
        from waiwera_tpu.sim import tracer as tracer_mod
        from waiwera_tpu.sim.tracer import TracerResult

        dist = self.dist
        sim = self.base
        tracers = self.tracers
        npv = self.eos.num_primary_variables
        ghost_value = dist.to_local(jnp.asarray(sim.tracer0))
        statics = (
            dist._mesh_static,
            dist._route_static,
            dist._src_static,
            dist._rock_local,
        )
        loc = P(AXIS)
        rep = P()
        statics_specs = jax.tree_util.tree_map(lambda _: loc, statics)
        plan = dist.plan

        def local_tracer(
            mesh_st, route_st, src_st, rock, fluid, fluxes, x_last,
            al_last, x_last2, al_last2, gval, t0, t1, dt, dt_last, first,
            use_bdf2,
        ):
            sq = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
            mesh_st, route_st, rock = sq(mesh_st), sq(route_st), sq(rock)
            if src_st is not None:
                src_st = sq(src_st)
            fluid, fluxes, x_last, al_last, x_last2, al_last2, gval = (
                sq(fluid), fluxes[0], x_last[0], al_last[0], x_last2[0],
                al_last2[0], gval[0],
            )
            mesh_local = MeshArrays(
                face_cells=mesh_st["face_cells"],
                face_area=mesh_st["face_area"],
                face_distance=mesh_st["face_distance"],
                face_distance12=mesh_st["face_distance12"],
                face_gravity_normal=mesh_st["face_gravity_normal"],
                face_permeability_direction=mesh_st[
                    "face_permeability_direction"
                ],
                cell_volume=mesh_st["cell_volume"],
                is_ghost=mesh_st["is_ghost"],
                num_cells=plan.n_local,
                num_interior_cells=plan.n_local,
            )
            owned = route_st["owned"]
            p2p_send = route_st["p2p_send"]
            p2p_recv = route_st["p2p_recv"]

            def sync(a):
                out = a
                for r, perm in enumerate(dist._p2p_perms):
                    buf = a[p2p_send[r]]
                    rbuf = lax.ppermute(buf, AXIS, perm)
                    out = out.at[p2p_recv[r]].set(rbuf, mode="drop")
                return out

            reduce_sum = lambda v: lax.psum(v, AXIS)

            if src_st is not None:
                network = _LocalSources(
                    dist._network,
                    src_st["src_cell_local"],
                    src_st["src_owner_mask"],
                )
                rate, _ = network.flows(fluid, t0, t1)
                cells = network.arrays.cell
                frac = fluid.phase_flow_fractions()[cells][
                    :, jnp.asarray(tracers.phase_index)
                ]
                inj = network.tracer_injection(t0, t1)
            else:
                rate = cells = frac = inj = None

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
            res = tracer_mod.solve(
                tracers, mesh_local, fluid, rock, fluxes, npv,
                x_last, al_last, x_last2, al_last2, c_al, dt_eff, b_hist,
                cells, rate, frac, inj, gval,
                owned=owned, sync=sync, reduce_sum=reduce_sum,
            )
            ex = lambda a: a[None]
            return TracerResult(
                x=ex(res.x), al=ex(res.al),
                converged=ex(res.converged), iterations=ex(res.iterations),
            )

        out_spec = TracerResult(x=loc, al=loc, converged=loc,
                                iterations=loc)
        mapped = jax.shard_map(
            local_tracer,
            mesh=dist.device_mesh,
            in_specs=statics_specs
            + (loc, loc, loc, loc, loc, loc, loc, rep, rep, rep, rep,
               rep, rep),
            out_specs=out_spec,
            check_vma=False,
        )

        @jax.jit
        def tracer_step(fluid, fluxes, x_last, al_last, x_last2,
                        al_last2, t0, t1, dt, dt_last, first, use_bdf2):
            res = mapped(
                *statics, fluid, fluxes, x_last, al_last, x_last2,
                al_last2, ghost_value, t0, t1, dt, dt_last, first,
                use_bdf2,
            )
            return res._replace(
                converged=res.converged[0], iterations=res.iterations[0]
            )

        return tracer_step
