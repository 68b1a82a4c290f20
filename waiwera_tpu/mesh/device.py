"""Device-side mesh arrays.

The static geometry the assembly kernels need, as a pytree of jnp
arrays extracted once from the host Mesh.

Faces are stored in *canonical* order: every face oriented so
cell_l < cell_r (swapping the per-side distances and negating the
signed gravity normal keeps the flux kernel exactly invariant), then
sorted by (column offset, row). On rectilinear meshes in natural cell
order this makes each Jacobian band's faces one contiguous,
row-periodic slice, so DIA band packing is pure reshape/pad instead of
a 33M-element gather (ops.dia.band_plan). `face_perm`/`face_sign` map
canonical faces back to the host mesh's original order and orientation
for natural-order flux output (the AO analogue for faces,
dm_utils.F90:843-935).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from waiwera_tpu.mesh.core import Mesh

Array = jnp.ndarray


class MeshArrays(NamedTuple):
    face_cells: Array  # [F, 2] int32
    face_area: Array  # [F]
    face_distance: Array  # [F, 2]
    face_distance12: Array  # [F]
    face_gravity_normal: Array  # [F]
    face_permeability_direction: Array  # [F] int32
    cell_volume: Array  # [N]
    is_ghost: Array  # [N] bool
    num_cells: int
    num_interior_cells: int
    # canonical -> host face mapping (host numpy; not used in traced
    # code): host_flux[face_perm[f]] = face_sign[f] * device_flux[f]
    face_perm: Optional[np.ndarray] = None
    face_sign: Optional[np.ndarray] = None

    @property
    def num_faces(self) -> int:
        return self.face_area.shape[0]


def mesh_arrays(mesh: Mesh) -> MeshArrays:
    fc = np.asarray(mesh.face_cells, np.int64).copy()
    dist = np.asarray(mesh.face_distance, float).copy()
    gn = np.asarray(mesh.face_gravity_normal, float).copy()
    # orient: cell_l < cell_r (flux kernel invariant under the swap)
    flip = fc[:, 0] > fc[:, 1]
    fc[flip] = fc[flip][:, ::-1]
    dist[flip] = dist[flip][:, ::-1]
    gn[flip] = -gn[flip]
    # sort by (offset, row): bands become contiguous face runs
    off = fc[:, 1] - fc[:, 0]
    perm = np.lexsort((fc[:, 0], off))
    sign = np.where(flip, -1.0, 1.0)[perm]
    return MeshArrays(
        face_cells=jnp.asarray(fc[perm], jnp.int32),
        face_area=jnp.asarray(np.asarray(mesh.face_area)[perm]),
        face_distance=jnp.asarray(dist[perm]),
        face_distance12=jnp.asarray(
            np.asarray(mesh.face_distance12)[perm]
        ),
        face_gravity_normal=jnp.asarray(gn[perm]),
        face_permeability_direction=jnp.asarray(
            np.asarray(mesh.face_permeability_direction)[perm],
            jnp.int32,
        ),
        cell_volume=jnp.asarray(mesh.cell_volume),
        is_ghost=jnp.asarray(mesh.is_ghost),
        num_cells=mesh.num_cells,
        num_interior_cells=mesh.num_interior_cells,
        face_perm=perm,
        face_sign=sign,
    )


def fluxes_to_host_order(mesh: MeshArrays, fluxes) -> np.ndarray:
    """Map canonical-order face values [F, k] back to the host mesh's
    face order and orientation (for /face_fields output)."""
    a = np.asarray(fluxes)
    if mesh.face_perm is None:
        return a
    out = np.empty_like(a)
    out[mesh.face_perm] = a * np.asarray(mesh.face_sign)[
        (...,) + (None,) * (a.ndim - 1)
    ]
    return out
