"""Batched small-block (1x1..4x4) linear algebra in pure jnp.

The Jacobian blocks are tiny (block size = number of primary
variables, 1..4), so closed-form adjugate inverses vectorise over
millions of blocks where batched library factorisations would not.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray


def invert_blocks(a: Array) -> Array:
    """Inverse of a batch of small square matrices [..., b, b],
    b in 1..4, via adjugate / determinant."""
    b = a.shape[-1]
    if b == 1:
        return 1.0 / a
    if b == 2:
        a00 = a[..., 0, 0]
        a01 = a[..., 0, 1]
        a10 = a[..., 1, 0]
        a11 = a[..., 1, 1]
        det = a00 * a11 - a01 * a10
        inv_det = 1.0 / det
        return jnp.stack(
            [
                jnp.stack([a11, -a01], axis=-1),
                jnp.stack([-a10, a00], axis=-1),
            ],
            axis=-2,
        ) * inv_det[..., None, None]
    if b == 3:
        m = a
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = (
            m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        )
        inv_det = 1.0 / det
        adj = jnp.stack(
            [
                jnp.stack([c00, c10, c20], axis=-1),
                jnp.stack([c01, c11, c21], axis=-1),
                jnp.stack([c02, c12, c22], axis=-1),
            ],
            axis=-2,
        )
        return adj * inv_det[..., None, None]
    if b == 4:
        # full adjugate/determinant (Schur on a fixed sub-block fails
        # when that sub-block is singular, e.g. wsge salt rows whose
        # P/T derivatives vanish)
        def minor3(rows, cols):
            sub = a[..., rows, :][..., :, cols]
            return (
                sub[..., 0, 0] * (sub[..., 1, 1] * sub[..., 2, 2]
                                  - sub[..., 1, 2] * sub[..., 2, 1])
                - sub[..., 0, 1] * (sub[..., 1, 0] * sub[..., 2, 2]
                                    - sub[..., 1, 2] * sub[..., 2, 0])
                + sub[..., 0, 2] * (sub[..., 1, 0] * sub[..., 2, 1]
                                    - sub[..., 1, 1] * sub[..., 2, 0])
            )

        idx = [0, 1, 2, 3]
        cof = [[None] * 4 for _ in range(4)]
        for i in range(4):
            for j in range(4):
                rows = [r for r in idx if r != i]
                cols = [c for c in idx if c != j]
                cof[i][j] = ((-1.0) ** (i + j)) * minor3(rows, cols)
        det = sum(a[..., 0, j] * cof[0][j] for j in range(4))
        inv_det = 1.0 / det
        # adjugate = transpose of cofactor matrix
        adj = jnp.stack(
            [
                jnp.stack([cof[i][j] for i in range(4)], axis=-1)
                for j in range(4)
            ],
            axis=-2,
        )
        return adj * inv_det[..., None, None]
    raise NotImplementedError(f"block size {b} > 4")


# ---------------------------------------------------------------------
# Element-major ("em") block kernels: blocks stored as [b*b, N] with
# the batch axis LAST, so each block element is one contiguous [N]
# vector and every kernel is b*b-way elementwise arithmetic. Row i*b+j
# holds block element (i, j).
# ---------------------------------------------------------------------


def _det_em(e, rows, cols):
    """Laplace-expansion determinant over element accessor e(i,j)."""
    if len(rows) == 1:
        return e(rows[0], cols[0])
    acc = None
    for k, c in enumerate(cols):
        term = e(rows[0], c) * _det_em(
            e, rows[1:], cols[:k] + cols[k + 1 :]
        )
        if k % 2 == 1:
            term = -term
        acc = term if acc is None else acc + term
    return acc


def invert_blocks_em(a2: Array) -> Array:
    """Inverse of [b*b, N] element-major blocks (b in 1..4) via
    adjugate/determinant, all ops on [N]-vectors."""
    bb = a2.shape[0]
    b = int(round(bb ** 0.5))
    if b * b != bb:
        raise ValueError(f"not a square block: {bb} elements")

    def e(i, j):
        return a2[i * b + j]

    if b == 1:
        return 1.0 / a2
    idx = tuple(range(b))
    det = _det_em(e, idx, idx)
    inv_det = 1.0 / det
    rows = []
    for i in range(b):
        for j in range(b):
            rs = tuple(r for r in idx if r != j)
            cs = tuple(c for c in idx if c != i)
            cof = _det_em(e, rs, cs)
            if (i + j) % 2 == 1:
                cof = -cof
            rows.append(cof * inv_det)
    return jnp.stack(rows)


def matmul_em(a2: Array, b2: Array) -> Array:
    """[b*b, N] @ [b*b, N] blockwise product, element-major."""
    bb = a2.shape[0]
    b = int(round(bb ** 0.5))
    rows = []
    for i in range(b):
        for j in range(b):
            acc = None
            for k in range(b):
                t = a2[i * b + k] * b2[k * b + j]
                acc = t if acc is None else acc + t
            rows.append(acc)
    return jnp.stack(rows)


def apply_blocks_em(a2: Array, x: Array) -> Array:
    """y[n, i] = sum_j a2[i*b+j, n] * x[n, j] for x [N, b] (blockwise
    mat-vec with element-major blocks; a2's batch may be padded)."""
    bb = a2.shape[0]
    b = int(round(bb ** 0.5))
    n = x.shape[0]
    cols = []
    for i in range(b):
        acc = None
        for j in range(b):
            t = a2[i * b + j][:n] * x[:, j]
            acc = t if acc is None else acc + t
        cols.append(acc)
    return jnp.stack(cols, axis=1)


def em_from_batch(a: Array) -> Array:
    """[N, b, b] -> [b*b, N] (host/test convenience)."""
    n, b, _ = a.shape
    return a.reshape(n, b * b).T


def batch_from_em(a2: Array) -> Array:
    """[b*b, N] -> [N, b, b]."""
    bb, n = a2.shape
    b = int(round(bb ** 0.5))
    return a2.T.reshape(n, b, b)


def hessenberg_lstsq(H: Array, beta: Array, m: int) -> Array:
    """Solve min ||beta e1 - H y|| for upper-Hessenberg H [m+1, m]
    by Givens rotations (GMRES least squares), pure jnp."""
    return hessenberg_lstsq_res(H, beta, m)[0]


def hessenberg_lstsq_res(H: Array, beta: Array, m: int):
    """hessenberg_lstsq plus the per-step residual profile:
    res[j] = |g[j+1]| after processing column j, which is the GMRES
    residual norm achievable with j+1 Arnoldi vectors. Lets callers
    report true inner-iteration counts (PETSc KSPGetIterationNumber
    semantics) instead of whole-cycle multiples."""
    g = jnp.zeros(m + 1).at[0].set(beta)
    res = jnp.zeros(m)
    R = H
    for j in range(m):
        a = R[j, j]
        b = R[j + 1, j]
        r = jnp.sqrt(a * a + b * b)
        r_safe = jnp.where(r > 1e-300, r, 1.0)
        c = jnp.where(r > 1e-300, a / r_safe, 1.0)
        s = jnp.where(r > 1e-300, b / r_safe, 0.0)
        row_j = c * R[j] + s * R[j + 1]
        row_j1 = -s * R[j] + c * R[j + 1]
        R = R.at[j].set(row_j).at[j + 1].set(row_j1)
        gj = c * g[j] + s * g[j + 1]
        gj1 = -s * g[j] + c * g[j + 1]
        g = g.at[j].set(gj).at[j + 1].set(gj1)
        res = res.at[j].set(jnp.abs(gj1))
    # back substitution on R[:m, :m] (upper triangular)
    y = jnp.zeros(m)
    for j in range(m - 1, -1, -1):
        rhs = g[j] - jnp.dot(R[j, j + 1 :], y[j + 1 :]) if j + 1 < m else g[j]
        diag = R[j, j]
        y = y.at[j].set(
            jnp.where(jnp.abs(diag) > 1e-300, rhs / jnp.where(jnp.abs(diag) > 1e-300, diag, 1.0), 0.0)
        )
    return y, res
