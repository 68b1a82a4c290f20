"""Block compressed-sparse-row (BSR) matrices.

Replacement for the reference's PETSc MATBAIJ Jacobian
(ode.F90:266-287): square matrices of [num_rows] block rows with
uniform small square blocks (block size = number of primary variables
per cell, 1..4).

The sparsity pattern is static (mesh connectivity), built once on host;
only `data` is recomputed each Newton iteration, so SpMV jits into a
gather + batched small matmul + segment-sum, which XLA fuses well.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

Array = jnp.ndarray


class BSRStructure(NamedTuple):
    """Static sparsity (host-built, hashable by id for jit closures)."""

    indptr: Array  # [N+1] int32
    indices: Array  # [nnzb] int32 column block of each stored block
    rows: Array  # [nnzb] int32 row block of each stored block
    diag_pos: Array  # [N] int32 position of diagonal block of each row
    num_rows: int
    block_size: int


class BSRMatrix(NamedTuple):
    structure: BSRStructure
    data: Array  # [nnzb, b, b]

    def matvec(self, x: Array) -> Array:
        """y = A @ x with x, y of shape [N, b]."""
        s = self.structure
        xg = x[s.indices]  # [nnzb, b]
        prod = jnp.einsum(
            "kij,kj->ki", self.data, xg, precision=jax.lax.Precision.HIGHEST
        )  # [nnzb, b]
        y = jnp.zeros_like(x)
        return y.at[s.rows].add(prod)

    def diag_blocks(self) -> Array:
        return self.data[self.structure.diag_pos]  # [N, b, b]


def build_structure(
    num_cells: int, face_cells: np.ndarray, block_size: int
) -> BSRStructure:
    """Sparsity from mesh connectivity: a diagonal block per cell plus
    one block per face side (both cells interior to the matrix)."""
    rows = [np.arange(num_cells, dtype=np.int64)]
    cols = [np.arange(num_cells, dtype=np.int64)]
    if len(face_cells):
        rows.append(face_cells[:, 0])
        cols.append(face_cells[:, 1])
        rows.append(face_cells[:, 1])
        cols.append(face_cells[:, 0])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    # sort by (row, col), dedupe (duplicate faces between same cell pair
    # are merged: caller must accumulate into the right position)
    order = np.lexsort((cols, rows))
    rows = rows[order]
    cols = cols[order]
    keep = np.ones(len(rows), dtype=bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows = rows[keep]
    cols = cols[keep]
    indptr = np.zeros(num_cells + 1, dtype=np.int64)
    np.add.at(indptr[1:], rows, 1)
    indptr = np.cumsum(indptr)
    diag_pos = np.searchsorted(
        rows * num_cells + cols, np.arange(num_cells) * (num_cells + 1)
    )
    return BSRStructure(
        indptr=jnp.asarray(indptr, jnp.int32),
        indices=jnp.asarray(cols, jnp.int32),
        rows=jnp.asarray(rows, jnp.int32),
        diag_pos=jnp.asarray(diag_pos, jnp.int32),
        num_rows=num_cells,
        block_size=block_size,
    )


def face_block_positions(
    structure: BSRStructure, face_cells: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Positions in `data` of the (l, r) and (r, l) blocks of each face.

    Host-side helper used when scatter-adding face Jacobian blocks.
    """
    rows = np.asarray(structure.rows)
    cols = np.asarray(structure.indices)
    n = structure.num_rows
    key = rows.astype(np.int64) * n + cols
    lr = np.searchsorted(key, face_cells[:, 0].astype(np.int64) * n + face_cells[:, 1])
    rl = np.searchsorted(key, face_cells[:, 1].astype(np.int64) * n + face_cells[:, 0])
    return lr, rl


def assemble(
    structure: BSRStructure,
    diag: Array,
    face_lr: Array,
    face_rl: Array,
    pos_lr: Array,
    pos_rl: Array,
) -> BSRMatrix:
    """Assemble matrix data from per-cell diagonal blocks [N, b, b] and
    per-face off-diagonal blocks [F, b, b] at precomputed positions."""
    nnzb = structure.indices.shape[0]
    b = structure.block_size
    data = jnp.zeros((nnzb, b, b), diag.dtype)
    data = data.at[structure.diag_pos].add(diag)
    if face_lr is not None and face_lr.shape[0]:
        data = data.at[pos_lr].add(face_lr)
        data = data.at[pos_rl].add(face_rl)
    return BSRMatrix(structure=structure, data=data)
