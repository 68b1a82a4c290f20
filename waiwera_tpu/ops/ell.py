"""Scatter-free block SpMV via an ELL (padded fixed-width row) layout.

The BSR matvec does `y.at[rows].add(block @ x[col])` — an XLA
scatter-add, whose colliding updates serialise. Mesh
matrices have bounded row degree (1 diagonal + one block per cell
face, ~7 for hexahedral meshes), so the static sparsity converts to
ELL: every block row padded to the max degree K. SpMV then becomes

    y[n] = sum_k  data[n, k] @ x[indices[n, k]]

a gather + batched small matmul + dense reduction over K — no scatter
at all, and XLA fuses the whole thing into one memory-bound pass.

This replaces the PETSc MATBAIJ MatMult the reference leans on
(ode.F90:266-287, timestepper.F90:1725-1739 KSP solves). The ELL
tables are built once on host from the BSR structure; per-Newton
-iteration conversion of assembled BSR data is one gather, amortised
over the whole Krylov solve.

Padded slots point at the row's own diagonal column with zero data, so
no masking is needed in the matvec.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp
from jax import lax

Array = jnp.ndarray


class ELLStructure(NamedTuple):
    """Static ELL tables (host-built from a BSRStructure)."""

    indices: Array  # [N, K] int32 block column per slot (pad: own row)
    gather_pos: Array  # [N, K] int32 into BSR data padded by one
    # trailing zero block (pad slots point at position nnzb)
    num_rows: int
    block_size: int
    width: int  # K


class ELLMatrix(NamedTuple):
    indices: Array  # [N, K]
    data: Array  # [N, K, b, b] (pad slots zero)

    def matvec(self, x: Array) -> Array:
        """y = A @ x with x, y of shape [N, b]."""
        xg = x[self.indices]  # [N, K, b]
        return jnp.einsum(
            "nkij,nkj->ni",
            self.data,
            xg.astype(self.data.dtype),
            precision=lax.Precision.HIGHEST,
        )


def ell_structure_from_arrays(
    indptr: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    num_rows: int,
    block_size: int,
    width: Optional[int] = None,
) -> ELLStructure:
    """Build ELL tables from host CSR-ordered block coordinates.

    width: pad to this row width (>= max degree); lets distributed
    builds pad all devices to a common K.
    """
    counts = np.diff(indptr)
    k_max = int(counts.max()) if len(counts) else 1
    if width is None:
        width = k_max
    if width < k_max:
        raise ValueError(f"width {width} < max row degree {k_max}")
    nnzb = len(rows)
    n = num_rows
    indices = np.repeat(
        np.arange(n, dtype=np.int64)[:, None], width, axis=1
    )
    gather_pos = np.full((n, width), nnzb, dtype=np.int64)
    slot = np.arange(nnzb) - indptr[rows]  # position within each row
    indices[rows, slot] = cols
    gather_pos[rows, slot] = np.arange(nnzb)
    return ELLStructure(
        indices=jnp.asarray(indices, jnp.int32),
        gather_pos=jnp.asarray(gather_pos, jnp.int32),
        num_rows=n,
        block_size=block_size,
        width=width,
    )


def ell_structure(structure, width: Optional[int] = None) -> ELLStructure:
    """ELL tables from a solver.bsr.BSRStructure (host side)."""
    return ell_structure_from_arrays(
        np.asarray(structure.indptr),
        np.asarray(structure.rows),
        np.asarray(structure.indices),
        structure.num_rows,
        structure.block_size,
        width=width,
    )


def to_ell(mat, ell: ELLStructure, dtype=None) -> ELLMatrix:
    """Convert assembled BSR data to ELL layout (one gather).

    dtype: optionally down-cast (e.g. float32 for the inner Krylov
    solve, which halves the bytes the memory-bound SpMV streams).
    """
    b = ell.block_size
    data = jnp.concatenate(
        [mat.data, jnp.zeros((1, b, b), mat.data.dtype)], axis=0
    )
    d = data[ell.gather_pos]  # [N, K, b, b]
    if dtype is not None:
        d = d.astype(dtype)
    return ELLMatrix(indices=ell.indices, data=d)
