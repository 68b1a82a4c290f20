"""Geometric multigrid on the pressure block: the CPR preconditioner.

The reference keeps Krylov iteration counts low with ASM/ILU(0)
(timestepper.F90:1743-1835), whose sequential triangular solves are
not data-parallel; block-Jacobi is data-parallel but can need O(100s)
of BiCGStab iterations per solve at rtol 1e-5 on large models.
Reservoir simulators attack exactly this with
CPR — constrained pressure residual: the long-range elliptic error
lives in the pressure coupling, so precondition with

    z_p = MG(A_pp) r_p          (scalar geometric V-cycle)
    z   = C z_p + D_block^-1 (r - A C z_p)

where A_pp is the pressure-pressure scalar sub-matrix (block element
(0,0) of every DIA band) and the second stage is plain block-Jacobi
smoothing of the remaining local/hyperbolic error.

Everything here is data-parallel: the mesh box [nz, ny, nx] is
reconstructed from the band offsets {1, nx, nx*ny}, restriction /
prolongation are reshape-sums / repeats (piecewise-constant
aggregation, Galerkin coarse operators computed by masked aggregate
sums of the band arrays), and the smoother is damped Jacobi — no
gathers, no sequential dependencies, static shapes at every level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

Array = jnp.ndarray


class _Level(NamedTuple):
    """7-point scalar operator on an even-padded box [nz, ny, nx]:
    d diag, xp/xm/yp/ym/zp/zm couplings to the +-x/y/z neighbours
    (zero where no face, including pad cells whose diag is 1)."""

    d: Array
    xp: Array
    xm: Array
    yp: Array
    ym: Array
    zp: Array
    zm: Array
    raw_shape: tuple  # un-padded dims this level was built at


def _pad_even(a, diag=False):
    nz, ny, nx = a.shape
    pz, py, px = nz % 2, ny % 2, nx % 2
    if not (pz or py or px):
        return a
    a = jnp.pad(a, ((0, pz), (0, py), (0, px)))
    if diag:
        # pad cells are identity rows: diag 1, no couplings
        mask = np.zeros(a.shape, bool)
        mask[nz:, :, :] = True
        mask[:, ny:, :] = True
        mask[:, :, nx:] = True
        a = jnp.where(jnp.asarray(mask), 1.0, a)
    return a


def _shift(a, axis, step):
    """Neighbour values along axis (+1: value at index i+1), zeros in
    from the boundary."""
    n = a.shape[axis]
    pad = [(0, 0)] * a.ndim
    if step > 0:
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(1, None)
        pad[axis] = (0, 1)
    else:
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, n - 1)
        pad[axis] = (1, 0)
    return jnp.pad(a[tuple(sl)], pad)


def _matvec(lv: _Level, z: Array) -> Array:
    return (
        lv.d * z
        + lv.xp * _shift(z, 2, +1)
        + lv.xm * _shift(z, 2, -1)
        + lv.yp * _shift(z, 1, +1)
        + lv.ym * _shift(z, 1, -1)
        + lv.zp * _shift(z, 0, +1)
        + lv.zm * _shift(z, 0, -1)
    )


def _agg_sum(a):
    Z, Y, X = a.shape
    return a.reshape(Z // 2, 2, Y // 2, 2, X // 2, 2).sum(
        axis=(1, 3, 5)
    )


def _parity_masks(shape):
    Z, Y, X = shape
    mx_even = (np.arange(X) % 2 == 0).reshape(1, 1, X)
    my_even = (np.arange(Y) % 2 == 0).reshape(1, Y, 1)
    mz_even = (np.arange(Z) % 2 == 0).reshape(Z, 1, 1)
    return (
        jnp.asarray(mx_even), jnp.asarray(my_even), jnp.asarray(mz_even)
    )


def _coarsen(lv: _Level) -> _Level:
    """Galerkin coarse operator for piecewise-constant 2x2x2
    aggregation: A_c[I,J] = sum_{i in I, j in J} A[i,j]. Internal
    couplings fold into the coarse diagonal; aggregate-crossing
    couplings become the coarse bands."""
    mx_e, my_e, mz_e = _parity_masks(lv.d.shape)
    dc = _agg_sum(
        lv.d
        + jnp.where(mx_e, lv.xp, 0.0) + jnp.where(~mx_e, lv.xm, 0.0)
        + jnp.where(my_e, lv.yp, 0.0) + jnp.where(~my_e, lv.ym, 0.0)
        + jnp.where(mz_e, lv.zp, 0.0) + jnp.where(~mz_e, lv.zm, 0.0)
    )
    xp_c = _agg_sum(jnp.where(~mx_e, lv.xp, 0.0))
    xm_c = _agg_sum(jnp.where(mx_e, lv.xm, 0.0))
    yp_c = _agg_sum(jnp.where(~my_e, lv.yp, 0.0))
    ym_c = _agg_sum(jnp.where(my_e, lv.ym, 0.0))
    zp_c = _agg_sum(jnp.where(~mz_e, lv.zp, 0.0))
    zm_c = _agg_sum(jnp.where(mz_e, lv.zm, 0.0))
    raw = dc.shape
    return _Level(
        d=_pad_even(dc, diag=True),
        xp=_pad_even(xp_c), xm=_pad_even(xm_c),
        yp=_pad_even(yp_c), ym=_pad_even(ym_c),
        zp=_pad_even(zp_c), zm=_pad_even(zm_c),
        raw_shape=raw,
    )


def build_levels(lv0: _Level, min_dim: int = 4, max_levels: int = 8):
    levels = [lv0]
    while (
        len(levels) < max_levels
        and max(levels[-1].d.shape) > min_dim
        and min(levels[-1].d.shape) >= 2
    ):
        levels.append(_coarsen(levels[-1]))
    return levels


def _safe_inv(d):
    tiny = jnp.asarray(1e-300, d.dtype) if d.dtype == jnp.float64 \
        else jnp.asarray(1e-30, d.dtype)
    return jnp.where(jnp.abs(d) > tiny, 1.0 / jnp.where(
        jnp.abs(d) > tiny, d, 1.0), 1.0)


def vcycle(levels, r: Array, omega=0.8, nu1=1, nu2=1, coarse_sweeps=24,
           alpha=1.5):
    """One V-cycle for A z = r on levels[0] (r in the level's padded
    shape; pad entries must be zero).

    alpha: coarse-grid over-correction weight. Piecewise-constant
    aggregation under-estimates smooth error (the Galerkin coarse
    operator is too stiff by roughly the aggregate diameter), and
    scaling the prolongated correction by ~1.5 is the standard
    smoothed-aggregation-lite remedy."""
    lv = levels[0]
    dinv = _safe_inv(lv.d)
    if len(levels) == 1:
        z = omega * dinv * r
        for _ in range(coarse_sweeps - 1):
            z = z + omega * dinv * (r - _matvec(lv, z))
        return z
    z = omega * dinv * r  # first sweep from z=0
    for _ in range(nu1 - 1):
        z = z + omega * dinv * (r - _matvec(lv, z))
    res = r - _matvec(lv, z)
    rc = _agg_sum(res)
    nxt = levels[1]
    Zc, Yc, Xc = rc.shape
    Zp, Yp, Xp = nxt.d.shape
    rc = jnp.pad(rc, ((0, Zp - Zc), (0, Yp - Yc), (0, Xp - Xc)))
    zc = vcycle(levels[1:], rc, omega, nu1, nu2, coarse_sweeps, alpha)
    zc = zc[:Zc, :Yc, :Xc]
    z = z + alpha * jnp.repeat(
        jnp.repeat(jnp.repeat(zc, 2, axis=0), 2, axis=1), 2, axis=2
    )
    for _ in range(nu2):
        z = z + omega * dinv * (r - _matvec(lv, z))
    return z


def box_dims(offsets, num_rows):
    """Reconstruct [nz(+ghost layers), ny, nx] from band offsets
    {0, +-1, +-nx, +-nx*ny}; None if the band set is not a 3D box."""
    pos = sorted(int(d) for d in offsets if int(d) > 0)
    if len(pos) != 3:
        return None
    sx, sy, sz = pos
    if sx != 1 or sy <= 1 or sz % sy != 0:
        return None
    if any(-d not in offsets for d in pos):
        return None
    nx = sy
    ny = sz // sy
    nz = -(-num_rows // sz)
    return nz, ny, nx


def pressure_levels(m64, dtype=None):
    """MG hierarchy for the pressure-pressure scalar sub-matrix of a
    block-DIA Jacobian (element (0,0) of every band), or None when the
    offsets are not a 3D box stencil."""
    dims = box_dims(m64.offsets, m64.num_rows)
    if dims is None:
        return None
    nz, ny, nx = dims
    n = m64.num_rows
    total = nz * ny * nx
    offs = [int(d) for d in m64.offsets]

    def band3(d, diag=False):
        if d not in offs:
            return jnp.zeros((nz, ny, nx), m64.bands.dtype)
        v = m64.bands[offs.index(d), 0, :n]
        if dtype is not None:
            v = v.astype(dtype)
        fill = 1.0 if diag else 0.0
        v = jnp.pad(v, (0, total - n), constant_values=fill)
        return v.reshape(nz, ny, nx)

    sx, sy, sz = 1, nx, nx * ny
    lv0 = _Level(
        d=_pad_even(band3(0, diag=True), diag=True),
        xp=_pad_even(band3(sx)), xm=_pad_even(band3(-sx)),
        yp=_pad_even(band3(sy)), ym=_pad_even(band3(-sy)),
        zp=_pad_even(band3(sz)), zm=_pad_even(band3(-sz)),
        raw_shape=(nz, ny, nx),
    )
    return build_levels(lv0), dims


def cpr_apply(levels, dims, base_mv, dinv2_apply, n, npv,
              cycles: int = 1):
    """CPR application z = C z_p + D_block^-1 (r - A C z_p)."""
    nz, ny, nx = dims
    total = nz * ny * nx
    Zp, Yp, Xp = levels[0].d.shape

    def apply(r: Array) -> Array:
        rp = r[:, 0]
        r3 = jnp.pad(rp, (0, total - n)).reshape(nz, ny, nx)
        r3 = jnp.pad(
            r3, ((0, Zp - nz), (0, Yp - ny), (0, Xp - nx))
        )
        z3 = vcycle(levels, r3)
        for _ in range(cycles - 1):
            z3 = z3 + vcycle(levels, r3 - _matvec(levels[0], z3))
        zp = z3[:nz, :ny, :nx].reshape(total)[:n]
        z1 = jnp.zeros_like(r).at[:, 0].set(zp.astype(r.dtype))
        r2 = r - base_mv(z1)
        return z1 + dinv2_apply(r2)

    return apply
