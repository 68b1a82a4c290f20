"""Krylov solvers: BiCGStab (reference default), restarted GMRES,
LGMRES (augmented restarts) and BiCGStab(l).

jnp replacements for the four PETSc KSP types Waiwera configures
(timestepper.F90:1725-1739: bcgs default, gmres / lgmres / bcgsl
alternatives). All are right-preconditioned and run under
lax.while_loop with early exit, so a whole Newton step stays on device.

Vectors are [N, b] (block rows); dot products reduce over everything.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

Array = jnp.ndarray

# f32 contractions run in full f32: without it a GPU may take them in
# TF32, which keeps ~3 of float32's ~7 significant digits
_HIGHEST = lax.Precision.HIGHEST


def _mm(a: Array, b: Array) -> Array:
    return jnp.matmul(a, b, precision=_HIGHEST)


DEFAULT_RTOL = 1e-5  # PETSc KSP default relative tolerance
DEFAULT_ATOL = 1e-50


class KrylovResult(NamedTuple):
    x: Array
    iterations: Array  # int32
    residual_norm: Array
    converged: Array  # bool


def _identity(x: Array) -> Array:
    return x


def bicgstab(
    matvec: Callable[[Array], Array],
    b: Array,
    x0: Optional[Array] = None,
    precond: Optional[Callable[[Array], Array]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    max_iterations: int = 1000,
    reduce_sum: Callable[[Array], Array] = _identity,
) -> KrylovResult:
    """Right-preconditioned BiCGStab for A x = b.

    reduce_sum: combines partial reductions across devices (lax.psum
    under shard_map; identity on a single device). All dot products /
    norms are local contractions followed by reduce_sum, so the solver
    runs unchanged over domain-decomposed vectors.

    True-residual safeguarding: the BiCGStab recurrence residual can
    drift from b - A x (round-off accumulation, worst with strong or
    ill-scaled preconditioners in f32) and can break down when the
    shadow residual dot rho underflows; either way the recurrence
    claims convergence the true residual does not support. Each
    convergence-by-recurrence therefore re-evaluates the TRUE residual
    and, if it is still above tol, restarts the recurrence from the
    current iterate with a fresh shadow vector (at most 3 rounds; a
    few extra matvecs total). PETSc users know this as the difference
    between preconditioned-recurrence and true-residual convergence
    monitoring.
    """
    if precond is None:
        precond = lambda v: v

    def _dot(a: Array, b_: Array) -> Array:
        return reduce_sum(jnp.vdot(a, b_, precision=_HIGHEST))

    def _norm(a: Array) -> Array:
        return jnp.sqrt(jnp.real(_dot(a, a)))
    tiny = float(jnp.finfo(b.dtype).tiny)
    x = jnp.zeros_like(b) if x0 is None else x0
    bnorm = _norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    def body(state):
        x, r, r0, p, rho, k, _ = state
        phat = precond(p)
        v = matvec(phat)
        denom = _dot(r0, v)
        alpha = rho / jnp.where(denom != 0, denom, tiny)
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        tt = _dot(t, t)
        omega = _dot(t, s) / jnp.where(tt != 0, tt, tiny)
        x_new = x + alpha * phat + omega * shat
        r_new = s - omega * t
        rho_new = _dot(r0, r_new)
        beta = (rho_new / jnp.where(rho != 0, rho, tiny)) * (
            alpha / jnp.where(omega != 0, omega, tiny)
        )
        p_new = r_new + beta * (p - omega * v)
        return (x_new, r_new, r0, p_new, rho_new, k + 1, _norm(r_new))

    def cond(state):
        x, r, r0, p, rho, k, rnorm = state
        return (rnorm > tol) & (k < max_iterations) & jnp.isfinite(rnorm)

    # outer safeguard loop nests the recurrence while_loop so the
    # graph holds ONE copy of the body (an unrolled version tripled
    # compile time); each round enters from the TRUE residual
    def round_cond(carry):
        x, k, rnorm, rnd = carry
        return (
            (rnorm > tol) & (rnd < 3) & (k < max_iterations)
            & jnp.isfinite(rnorm)
        )

    def round_body(carry):
        x, k, _, rnd = carry
        r = b - matvec(x)
        state = (x, r, r, r, _dot(r, r), k, _norm(r))
        x, r, _, _, _, k, _ = lax.while_loop(cond, body, state)
        return (x, k, _norm(b - matvec(x)), rnd + 1)

    r0n = _norm(b - matvec(x))
    x, k, rnorm, _ = lax.while_loop(
        round_cond, round_body, (x, jnp.int32(0), r0n, jnp.int32(0))
    )
    return KrylovResult(
        x=x,
        iterations=k,
        residual_norm=rnorm,
        converged=(rnorm <= tol) & jnp.isfinite(rnorm),
    )


def gmres(
    matvec: Callable[[Array], Array],
    b: Array,
    x0: Optional[Array] = None,
    precond: Optional[Callable[[Array], Array]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    restart: int = 30,
    max_restarts: int = 40,
    reduce_sum: Callable[[Array], Array] = _identity,
    basis_dtype=None,
) -> KrylovResult:
    """Right-preconditioned restarted GMRES(m).

    Arnoldi with two-pass classical Gram-Schmidt (CGS2): fully
    vectorised over the basis, which maps to matrix-vector products
    rather than a sequential MGS scan. reduce_sum as in bicgstab: all
    basis contractions are local matmuls + one cross-device reduction.

    basis_dtype: storage dtype for the Arnoldi basis V [m+1, n] — the
    solver's dominant workspace (restart 30 at n=4.7M dofs is ~1.2 GB
    in f64). float32 halves it while H, the Givens least-squares and
    all solution updates stay in b.dtype (the basis is only a set of
    directions; rounding them costs a little orthogonality, not
    solution accuracy). The reference's aux/tracer GMRES runs this way
    at scale (timestepper.F90:1840-1851 analogue).
    """
    if precond is None:
        precond = lambda v: v
    v_dtype = b.dtype if basis_dtype is None else jnp.dtype(basis_dtype)

    def _dot(a: Array, b_: Array) -> Array:
        return reduce_sum(jnp.vdot(a, b_, precision=_HIGHEST))

    def _norm(a: Array) -> Array:
        return jnp.sqrt(jnp.real(_dot(a, a)))
    tiny = float(jnp.finfo(b.dtype).tiny)
    x = jnp.zeros_like(b) if x0 is None else x0
    shape = b.shape
    n = b.size
    bnorm = _norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)
    m = restart

    def flat(v):
        return v.reshape(n)

    def unflat(v):
        return v.reshape(shape)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = _norm(r)

        V = jnp.zeros((m + 1, n), v_dtype)
        H = jnp.zeros((m + 1, m), b.dtype)
        V = V.at[0].set(
            (flat(r) / jnp.where(beta != 0, beta, tiny)).astype(v_dtype)
        )

        def body(j, carry):
            V, H, brk = carry
            v_j = unflat(V[j]).astype(b.dtype)
            w = flat(matvec(precond(v_j)))
            # CGS2 against the full basis (rows > j are zero);
            # V @ w is a local contraction, reduced across devices.
            # Mixed-dtype contractions promote to b.dtype, so H and
            # the correction arithmetic keep full precision even with
            # an f32-stored basis.
            h1 = reduce_sum(_mm(V, w))  # [m+1]
            w = w - _mm(V.T, h1)
            h2 = reduce_sum(_mm(V, w))
            w = w - _mm(V.T, h2)
            h = h1 + h2
            wnorm = jnp.sqrt(reduce_sum(_mm(w, w)))
            H_new = H.at[:, j].set(h)
            H_new = H_new.at[j + 1, j].set(wnorm)
            V_new = V.at[j + 1].set(
                (w / jnp.where(wnorm > tiny, wnorm, 1.0)).astype(
                    v_dtype
                )
            )
            return (V_new, H_new, brk | (wnorm <= tiny))

        V, H, _ = lax.fori_loop(0, m, body, (V, H, False))

        # solve least squares min ||beta e1 - H y|| by Givens rotations
        # (no LAPACK custom calls for an (m+1) x m system)
        from waiwera_tpu.solver.smallblocks import hessenberg_lstsq_res

        y, res_profile = hessenberg_lstsq_res(H, beta, m)
        y = y.astype(b.dtype)
        dx = _mm(V[:m].T, y)  # [n]
        x_new = x + precond(unflat(dx))
        # true inner-iteration count: the GMRES residual after j+1
        # Arnoldi steps is res_profile[j] (monotone), so the final
        # partial cycle counts only the steps it needed. Note this
        # profile is the RIGHT-PRECONDITIONED least-squares residual
        # while the outer test uses the unpreconditioned norm, so the
        # count can differ slightly from PETSc KSPGetIterationNumber
        # (right preconditioning leaves the two equal in exact
        # arithmetic; CGS2 round-off makes them near-equal in practice)
        inner = jnp.minimum(
            jnp.sum(res_profile > tol).astype(jnp.int32) + 1, m
        )
        return x_new, inner

    def cond(state):
        x, k, its, rnorm = state
        return (rnorm > tol) & (k < max_restarts) & jnp.isfinite(rnorm)

    def body(state):
        x, k, its, _ = state
        x_new, inner = arnoldi_cycle(x)
        rnorm = _norm(b - matvec(x_new))
        return (x_new, k + 1, its + inner, rnorm)

    r0n = _norm(b - matvec(x))
    x, k, its, rnorm = lax.while_loop(
        cond, body, (x, jnp.int32(0), jnp.int32(0), r0n)
    )
    return KrylovResult(
        x=x,
        iterations=its,
        residual_norm=rnorm,
        converged=(rnorm <= tol) & jnp.isfinite(rnorm),
    )


def lgmres(
    matvec: Callable[[Array], Array],
    b: Array,
    x0: Optional[Array] = None,
    precond: Optional[Callable[[Array], Array]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    restart: int = 30,
    augment: int = 2,
    max_restarts: int = 40,
    reduce_sum: Callable[[Array], Array] = _identity,
    basis_dtype=None,
) -> KrylovResult:
    """Loose GMRES (Baker, Jessup & Manteuffel 2005), the PETSc
    KSPLGMRES the reference selects with linear type "lgmres"
    (timestepper.F90:1731-1734).

    basis_dtype: storage dtype for the V/Q workspaces (see gmres) —
    2*(m+1)*n values, the memory hot spot at large n.

    Each cycle's subspace is `restart - augment` Arnoldi vectors plus
    the `augment` most recent approximate error vectors z_i = x_{i} -
    x_{i-1} (one per previous cycle), so convergence information
    survives the restart. Cycles before the z buffer fills substitute
    plain Arnoldi directions, making the first cycle exactly
    GMRES(restart). Fixed shapes: the z buffer is a carried [k, n]
    array with a validity count, so the whole solve stays one
    lax.while_loop.
    """
    if precond is None:
        precond = lambda v: v
    k_aug = max(int(augment), 0)
    m = restart
    m_a = m - k_aug  # Arnoldi depth per cycle
    if m_a < 1:
        raise ValueError("lgmres restart must exceed augment")
    v_dtype = b.dtype if basis_dtype is None else jnp.dtype(basis_dtype)

    def _dot(a: Array, b_: Array) -> Array:
        return reduce_sum(jnp.vdot(a, b_, precision=_HIGHEST))

    def _norm(a: Array) -> Array:
        return jnp.sqrt(jnp.real(_dot(a, a)))

    tiny = float(jnp.finfo(b.dtype).tiny)
    x = jnp.zeros_like(b) if x0 is None else x0
    shape = b.shape
    n = b.size
    bnorm = _norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    def flat(v):
        return v.reshape(n)

    def unflat(v):
        return v.reshape(shape)

    from waiwera_tpu.solver.smallblocks import hessenberg_lstsq_res

    def cycle(x, Z, nz):
        r = b - matvec(x)
        beta = _norm(r)

        V = jnp.zeros((m + 1, n), v_dtype)
        H = jnp.zeros((m + 1, m), b.dtype)
        Q = jnp.zeros((m, n), v_dtype)  # actual direction vectors
        V = V.at[0].set(
            (flat(r) / jnp.where(beta != 0, beta, tiny)).astype(v_dtype)
        )

        def body(j, carry):
            V, H, Q, brk = carry
            v_j = unflat(V[j]).astype(b.dtype)
            q = flat(precond(v_j))
            if k_aug > 0:
                zi = j - m_a
                use_z = (j >= m_a) & (zi < nz)
                qz = Z[jnp.clip(zi, 0, k_aug - 1)]
                q = jnp.where(use_z, qz, q)
            w = flat(matvec(unflat(q)))
            # CGS2 against the full basis (rows > j are zero)
            h1 = reduce_sum(_mm(V, w))
            w = w - _mm(V.T, h1)
            h2 = reduce_sum(_mm(V, w))
            w = w - _mm(V.T, h2)
            h = h1 + h2
            wnorm = jnp.sqrt(reduce_sum(_mm(w, w)))
            H_new = H.at[:, j].set(h)
            H_new = H_new.at[j + 1, j].set(wnorm)
            V_new = V.at[j + 1].set(
                w / jnp.where(wnorm > tiny, wnorm, 1.0)
            )
            Q_new = Q.at[j].set(q)
            return (V_new, H_new, Q_new, brk | (wnorm <= tiny))

        V, H, Q, _ = lax.fori_loop(0, m, body, (V, H, Q, False))
        y, res_profile = hessenberg_lstsq_res(H, beta, m)
        y = y.astype(b.dtype)
        dx = _mm(Q.T, y)  # [n] — Q columns already in solution space
        x_new = x + unflat(dx)
        inner = jnp.minimum(
            jnp.sum(res_profile > tol).astype(jnp.int32) + 1, m
        )
        if k_aug > 0:
            dxn = jnp.sqrt(reduce_sum(_mm(dx, dx)))
            z_new = dx / jnp.where(dxn > tiny, dxn, 1.0)
            Z = jnp.roll(Z, 1, axis=0).at[0].set(z_new)
            nz = jnp.minimum(nz + 1, k_aug)
        return x_new, Z, nz, inner

    def cond(state):
        x, k, its, rnorm, Z, nz = state
        return (rnorm > tol) & (k < max_restarts) & jnp.isfinite(rnorm)

    def body(state):
        x, k, its, _, Z, nz = state
        x_new, Z, nz, inner = cycle(x, Z, nz)
        rnorm = _norm(b - matvec(x_new))
        return (x_new, k + 1, its + inner, rnorm, Z, nz)

    Z0 = jnp.zeros((max(k_aug, 1), n), b.dtype)
    r0n = _norm(b - matvec(x))
    x, k, its, rnorm, _, _ = lax.while_loop(
        cond, body, (x, jnp.int32(0), jnp.int32(0), r0n, Z0, jnp.int32(0))
    )
    return KrylovResult(
        x=x,
        iterations=its,
        residual_norm=rnorm,
        converged=(rnorm <= tol) & jnp.isfinite(rnorm),
    )


def bicgstab_l(
    matvec: Callable[[Array], Array],
    b: Array,
    x0: Optional[Array] = None,
    precond: Optional[Callable[[Array], Array]] = None,
    rtol: float = DEFAULT_RTOL,
    atol: float = DEFAULT_ATOL,
    ell: int = 2,
    max_iterations: int = 1000,
    reduce_sum: Callable[[Array], Array] = _identity,
) -> KrylovResult:
    """BiCGStab(l) (Sleijpen & Fokkema 1993), PETSc's KSPBCGSL — the
    reference's "bcgsl" linear type (timestepper.F90:1735-1738).

    Each outer sweep does l BiCG steps followed by an l-dimensional
    minimal-residual polynomial update, which smooths the erratic
    convergence plain BiCGStab shows on strongly nonsymmetric systems.
    Right preconditioning is applied by running the sweep on op = A∘M
    and mapping the accumulated update through M once at the end
    (both are linear), so the preconditioner cost matches bicgstab's.
    """
    if precond is None:
        precond = lambda v: v
    op = lambda v: matvec(precond(v))
    L = int(ell)

    def _dot(a: Array, b_: Array) -> Array:
        return reduce_sum(jnp.vdot(a, b_, precision=_HIGHEST))

    def _norm(a: Array) -> Array:
        return jnp.sqrt(jnp.real(_dot(a, a)))

    tiny = float(jnp.finfo(b.dtype).tiny)

    def safe(x):
        return jnp.where(jnp.abs(x) > tiny, x, tiny)

    y0 = jnp.zeros_like(b)  # accumulated update in preconditioned space
    r0 = b if x0 is None else b - matvec(x0)
    rshadow = r0
    bnorm = _norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    # carried state: y, R [L+1, N, nb], U [L+1, N, nb], rho0, alpha,
    # omega, iteration count, rnorm
    R0 = jnp.zeros((L + 1,) + b.shape, b.dtype).at[0].set(r0)
    U0 = jnp.zeros_like(R0)

    def cond(st):
        y, R, U, rho0, alpha, omega, k, rnorm = st
        return (rnorm > tol) & (k < max_iterations) & jnp.isfinite(rnorm)

    def body(st):
        y, R, U, rho0, alpha, omega, k, _ = st
        rho0 = -omega * rho0

        # --- BiCG part ------------------------------------------------
        for j in range(L):
            rho1 = _dot(R[j], rshadow)
            beta = alpha * rho1 / safe(rho0)
            rho0 = rho1
            for i in range(j + 1):
                U = U.at[i].set(R[i] - beta * U[i])
            U = U.at[j + 1].set(op(U[j]))
            gamma = _dot(U[j + 1], rshadow)
            alpha = rho0 / safe(gamma)
            for i in range(j + 1):
                R = R.at[i].set(R[i] - alpha * U[i + 1])
            R = R.at[j + 1].set(op(R[j]))
            y = y + alpha * U[0]

        # --- MR part: modified Gram-Schmidt on R[1..L] -----------------
        tau = [[None] * (L + 1) for _ in range(L + 1)]
        sigma = [None] * (L + 1)
        gam_p = [None] * (L + 1)
        for j in range(1, L + 1):
            for i in range(1, j):
                tij = _dot(R[j], R[i]) / safe(sigma[i])
                tau[i][j] = tij
                R = R.at[j].set(R[j] - tij * R[i])
            sigma[j] = _dot(R[j], R[j])
            gam_p[j] = _dot(R[0], R[j]) / safe(sigma[j])

        gam = [None] * (L + 1)
        gam[L] = gam_p[L]
        omega = gam[L]
        for j in range(L - 1, 0, -1):
            gam[j] = gam_p[j] - sum(
                tau[j][i] * gam[i] for i in range(j + 1, L + 1)
            )
        gam_pp = [None] * L
        for j in range(1, L):
            gam_pp[j] = gam[j + 1] + sum(
                tau[j][i] * gam[i + 1] for i in range(j + 1, L)
            )

        y = y + gam[1] * R[0]
        R = R.at[0].set(R[0] - gam_p[L] * R[L])
        U = U.at[0].set(U[0] - gam[L] * U[L])
        for j in range(1, L):
            U = U.at[0].set(U[0] - gam[j] * U[j])
            y = y + gam_pp[j] * R[j]
            R = R.at[0].set(R[0] - gam_p[j] * R[j])

        return (y, R, U, rho0, alpha, omega, k + L, _norm(R[0]))

    st0 = (
        y0, R0, U0,
        jnp.ones((), b.dtype), jnp.zeros((), b.dtype),
        jnp.ones((), b.dtype), jnp.int32(0), _norm(r0),
    )
    y, R, U, rho0, alpha, omega, k, rnorm = lax.while_loop(
        cond, body, st0
    )
    x = precond(y)
    if x0 is not None:
        x = x + x0
    return KrylovResult(
        x=x,
        iterations=k,
        residual_norm=rnorm,
        converged=(rnorm <= tol) & jnp.isfinite(rnorm),
    )


def solve(
    method: str,
    matvec,
    b,
    precond=None,
    rtol: float = DEFAULT_RTOL,
    max_iterations: int = 1000,
    restart: int = 30,
    augment: int = 2,
    ell: int = 2,
    **kw,
) -> KrylovResult:
    """KSP-style dispatch by the reference's JSON linear-solver names
    (timestepper.F90:1725-1739)."""
    if method in ("bcgs", "bicgstab", "bcgsl", "bicgstabl"):
        # short-recurrence methods carry no large basis
        kw.pop("basis_dtype", None)
    if method in ("bcgs", "bicgstab"):
        return bicgstab(
            matvec, b, precond=precond, rtol=rtol,
            max_iterations=max_iterations, **kw,
        )
    max_restarts = max(1, -(-int(max_iterations) // max(restart, 1)))
    if method == "gmres":
        return gmres(
            matvec, b, precond=precond, rtol=rtol, restart=restart,
            max_restarts=max_restarts, **kw,
        )
    if method == "lgmres":
        return lgmres(
            matvec, b, precond=precond, rtol=rtol, restart=restart,
            augment=augment, max_restarts=max_restarts, **kw,
        )
    if method in ("bcgsl", "bicgstabl"):
        return bicgstab_l(
            matvec, b, precond=precond, rtol=rtol, ell=ell,
            max_iterations=max_iterations, **kw,
        )
    raise ValueError(f"unknown linear solver: {method!r}")
