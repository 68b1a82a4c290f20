"""Host-side mesh partitioning for multi-device runs.

Counterpart of the reference's DMPlexDistribute + PetscPartitioner
domain decomposition with overlap-1 halos (mesh.F90:40,143-171): cells
are split into near-equal blocks by recursive coordinate bisection of
their centroids, every face is replicated onto each device owning one
of its cells, and halo routing tables are precomputed so the exchange
runs as one all_gather over the device mesh axis.

All plan arrays are stacked with a leading device axis [D, ...] and
padded to per-device maxima, so shapes are static under shard_map.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from waiwera_tpu.mesh.core import Mesh


class PartitionPlan(NamedTuple):
    """Static routing tables (host numpy, device axis leading)."""

    num_devices: int
    n_local: int  # padded per-device local cell count (owned + halo)
    n_owned: np.ndarray  # [D] real owned-cell counts
    num_send: int  # padded send-buffer length S
    # local slot -> global cell (pad slots point at cell 0, masked out)
    local_cells: np.ndarray  # [D, n_local] int32
    owned_mask: np.ndarray  # [D, n_local] bool
    # faces replicated per device, local endpoint indices. Faces are
    # stored in per-device canonical orientation (local cell_l <
    # cell_r for owned-owned faces; the flux kernel is exactly
    # invariant when the per-side distances swap and the signed
    # gravity normal negates — mesh.device mesh_arrays does the same
    # globally). face_flip marks faces whose host orientation was
    # swapped (geometry slicing + flux output sign).
    face_ids: np.ndarray  # [D, f_local] int32 global face ids
    face_cells_local: np.ndarray  # [D, f_local, 2] int32
    face_mask: np.ndarray  # [D, f_local] bool
    face_flip: np.ndarray  # [D, f_local] bool
    # halo exchange: pack owned slots send_idx into a send buffer,
    # all_gather over devices, then pull recv_src out of the flat
    # [D * S] gathered buffer into the halo slots [n_owned_pad:].
    send_idx: np.ndarray  # [D, S] int32 local slots to send
    recv_src: np.ndarray  # [D, n_halo] int32 flat gathered index
    n_owned_pad: int  # halo slots start here in every device
    n_halo: int  # padded halo count
    # point-to-point exchange (PetscSF analogue): the directed
    # neighbour graph edge-colored into rounds where each device sends
    # at most one buffer and receives at most one (a partial
    # permutation -> one lax.ppermute per round). O(rounds * S_edge)
    # traffic instead of the all_gather's O(D * S).
    p2p_perms: tuple  # per round: tuple of (src, dst) device pairs
    p2p_send: np.ndarray  # [D, R, S_e] int32 local slots to pack
    p2p_recv: np.ndarray  # [D, R, S_e] int32 halo slot (pad: n_local)
    # owner device + owner-local slot of every global cell (for
    # scattering global arrays to devices and gathering results back)
    cell_device: np.ndarray  # [N] int32
    cell_slot: np.ndarray  # [N] int32


def _csr_adjacency(face_cells: np.ndarray, ids: np.ndarray, n: int):
    """CSR adjacency of the cell graph induced on `ids` (renumbered
    0..len(ids)-1). Returns (indptr, indices)."""
    g2s = np.full(n, -1, np.int64)
    g2s[ids] = np.arange(len(ids))
    a = g2s[face_cells[:, 0]]
    b = g2s[face_cells[:, 1]]
    keep = (a >= 0) & (b >= 0)
    a, b = a[keep], b[keep]
    rows = np.concatenate([a, b])
    cols = np.concatenate([b, a])
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(len(ids) + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols


def _edge_cut(part: np.ndarray, face_cells: np.ndarray) -> int:
    return int(np.sum(part[face_cells[:, 0]] != part[face_cells[:, 1]]))


def _local_rcm(own: np.ndarray, face_cells: np.ndarray, n: int):
    """Order a device's owned cells by reverse Cuthill-McKee when that
    reduces the local matrix bandwidth (native.rcm; the PETSc
    MatOrdering analogue). Lower local bandwidth makes the shift-based
    DILU/SGS sweeps propagate like proper level-set triangular solves
    on unstructured partitions. Natural order is kept on ties (banded
    meshes are already optimal)."""
    if len(own) <= 2:
        return own
    try:
        from waiwera_tpu import native

        indptr, indices = _csr_adjacency(face_cells, own, n)
        perm = native.rcm(indptr, indices, len(own))
    except Exception:
        return own

    def bandwidth(order):
        inv = np.empty(len(own), np.int64)
        inv[order] = np.arange(len(own))
        a, b = inv[indices], inv[np.repeat(
            np.arange(len(own)), np.diff(indptr)
        )]
        return int(np.abs(a - b).max()) if len(a) else 0

    ident = np.arange(len(own))
    if bandwidth(perm) < bandwidth(ident):
        return own[perm]
    return own


def _rcb(
    centroids: np.ndarray,
    ids: np.ndarray,
    num_parts: int,
    weights: np.ndarray = None,
):
    """Recursive coordinate bisection: split ids into num_parts
    near-equal groups by medians along the longest bounding-box axis.

    weights: optional per-global-cell work weights (length num_cells);
    splits then balance total weight instead of cell count (the
    DOF-weighted rebalance of mesh.F90:3618-3682, where MINC chains
    make cells unequal)."""
    if num_parts == 1:
        return [ids]
    n_left_parts = num_parts // 2
    frac = n_left_parts / num_parts
    span = centroids[ids].max(axis=0) - centroids[ids].min(axis=0)
    # ties (equal extents up to centroid rounding) go to the lowest
    # axis, so sibling halves of a rectilinear box split alike and the
    # parts stay congruent slabs (device-uniform banded face plans)
    axis = int(np.argmax(span >= span.max() * (1.0 - 1e-9)))
    order = ids[np.argsort(centroids[ids, axis], kind="stable")]
    if weights is None:
        k = int(round(len(ids) * frac))
    else:
        cw = np.cumsum(weights[order])
        k = int(np.searchsorted(cw, frac * cw[-1]))
    k = min(max(k, 1), len(ids) - 1)
    return _rcb(centroids, order[:k], n_left_parts, weights) + _rcb(
        centroids, order[k:], num_parts - n_left_parts, weights
    )


def _canonical_face_order(a_l, b_l, gh, owned_both):
    """Canonical per-device face order: owned-owned non-ghost faces
    with positive local offset first, grouped by (offset, row) — the
    order face_plan_direct detects as periodic slices. Cross-device,
    ghost and pad faces form the indexed tail."""
    banded = owned_both & ~gh & (b_l > a_l)
    off = np.where(banded, b_l - a_l, 0)
    return np.lexsort((a_l, off, ~banded))


def _has_common_plan(
    locals_, halos, faces, face_cells, is_ghost, part,
    n_owned_pad, n_local, num_devices,
):
    """Probe: does the natural local ordering admit ONE periodic face
    plan shared by every device? (Host-side; mirrors the detection in
    parallel.spmd so the two always agree.)"""
    from waiwera_tpu.ops import dia as ops_dia

    n = len(part)
    f_local = max((len(f) for f in faces), default=0) or 1
    common = None
    for d in range(num_devices):
        own, halo, fsel = locals_[d], halos[d], faces[d]
        g2l = np.full(n, -1, np.int64)
        g2l[own] = np.arange(len(own))
        g2l[halo] = n_owned_pad + np.arange(len(halo))
        fc_d = face_cells[fsel]
        a_l = g2l[fc_d[:, 0]]
        b_l = g2l[fc_d[:, 1]]
        a_l, b_l = np.minimum(a_l, b_l), np.maximum(a_l, b_l)
        gh = is_ghost[fc_d[:, 0]] | is_ghost[fc_d[:, 1]]
        owned_both = (part[fc_d[:, 0]] == d) & (part[fc_d[:, 1]] == d)
        order = _canonical_face_order(a_l, b_l, gh, owned_both)
        fcl = np.zeros((f_local, 2), np.int64)
        fcl[: len(fsel), 0] = a_l[order]
        fcl[: len(fsel), 1] = b_l[order]
        ghost_like = np.zeros(n_local, bool)
        ghost_like[: len(own)] = is_ghost[own]
        ghost_like[n_owned_pad:] = True  # halo slots out of the bands
        fp = ops_dia.face_plan_direct(fcl, ghost_like, n_local)
        if fp is None or (common is not None and fp != common):
            return False
        common = fp
    return common is not None


def build_partition(mesh: Mesh, num_devices: int) -> PartitionPlan:
    n = mesh.num_cells
    face_cells = np.asarray(mesh.face_cells, np.int64)
    nf = len(face_cells)
    centroids = np.asarray(mesh.cell_centroid, float)[:, : max(mesh.dim, 1)]

    # partition interior cells; Dirichlet ghost cells follow the
    # interior cell across their boundary face (mesh.F90:193-224 ghosts
    # live with their neighbour's rank). Two candidate partitioners —
    # RCB over centroids and the native greedy graph-growing
    # partitioner (the PetscPartitioner analogue, mesh.F90:946-947) —
    # scored by edge cut (halo traffic proxy) with a balance guard.
    is_ghost = np.asarray(mesh.is_ghost, bool)
    interior = np.nonzero(~is_ghost)[0]
    part = np.zeros(n, np.int64)
    # MINC meshes: partition the fracture/regular cells with each
    # weighted by its whole chain (1 + matrix cells), then place matrix
    # cells on their fracture cell's device — chains never cross
    # devices and balance counts DOF, not just fracture cells (the
    # explicit post-MINC rebalance of mesh.F90:3618-3682).
    minc_level = getattr(mesh, "minc_level", None)
    minc_parent = getattr(mesh, "minc_parent", None)
    has_minc = (
        minc_level is not None
        and minc_parent is not None
        and np.any(np.asarray(minc_level) > 0)
    )
    if has_minc:
        level = np.asarray(minc_level, np.int64)
        parent = np.asarray(minc_parent, np.int64)
        chain = np.bincount(parent[interior], minlength=n)
        prim = interior[level[interior] == 0]
        groups = _rcb(centroids, prim, num_devices, weights=chain)
    else:
        groups = _rcb(centroids, interior, num_devices)
    for d, ids in enumerate(groups):
        part[ids] = d
    if has_minc:
        mat = interior[level[interior] > 0]
        part[mat] = part[parent[mat]]
    if num_devices > 1:
        try:
            from waiwera_tpu import native

            indptr, indices = _csr_adjacency(
                face_cells, interior, n
            )
            part_g = native.partition_graph(
                indptr, indices, len(interior), num_devices
            )
            cand = np.zeros(n, np.int64)
            cand[interior] = part_g
            if has_minc:
                # keep chains whole on the candidate too
                cand[mat] = cand[parent[mat]]
            sizes = np.bincount(
                cand[interior], minlength=num_devices
            )
            ideal = len(interior) / num_devices
            balanced = (
                sizes.min() > 0 and sizes.max() <= 1.2 * ideal
            )
            if balanced:
                inner = ~(is_ghost[face_cells[:, 0]]
                          | is_ghost[face_cells[:, 1]])
                if _edge_cut(cand, face_cells[inner]) < _edge_cut(
                    part, face_cells[inner]
                ):
                    part = cand
        except Exception:
            pass  # native lib unavailable: keep RCB
    ghosts = np.nonzero(is_ghost)[0]
    if len(ghosts):
        # each ghost cell appears in faces; take its first neighbour
        owner = np.full(n, -1, np.int64)
        for side in (0, 1):
            g = face_cells[:, side]
            o = face_cells[:, 1 - side]
            sel = is_ghost[g] & ~is_ghost[o]
            owner[g[sel]] = o[sel]
        has = owner[ghosts] >= 0
        part[ghosts[has]] = part[owner[ghosts[has]]]

    # faces per device: replicate onto every device owning an endpoint
    part_l = part[face_cells[:, 0]]
    part_r = part[face_cells[:, 1]]

    locals_, halos, faces = [], [], []
    for d in range(num_devices):
        own = np.nonzero(part == d)[0]
        fsel = np.nonzero((part_l == d) | (part_r == d))[0]
        ends = np.unique(face_cells[fsel].ravel())
        halo = ends[part[ends] != d]
        locals_.append(own)
        halos.append(halo)
        faces.append(fsel)

    n_owned = np.array([len(o) for o in locals_], np.int64)
    n_owned_pad = int(n_owned.max()) if num_devices else 0
    n_halo = max((len(h) for h in halos), default=0)
    n_halo = max(n_halo, 1)  # keep exchange shapes non-empty
    f_local = max((len(f) for f in faces), default=0)
    f_local = max(f_local, 1)
    n_local = n_owned_pad + n_halo

    # Local ordering: keep the NATURAL (ascending-global) ordering when
    # it admits a device-uniform periodic face plan — that lights up
    # the gather-free banded Jacobian path under shard_map (uniform
    # partitions of rectilinear meshes; spmd.py detection). Otherwise
    # apply per-device RCM, which helps the DILU sweeps on
    # unstructured partitions but generally breaks plan uniformity.
    if not _has_common_plan(
        locals_, halos, faces, face_cells, is_ghost, part,
        n_owned_pad, n_local, num_devices,
    ):
        locals_ = [
            _local_rcm(own, face_cells, n) for own in locals_
        ]

    local_cells = np.zeros((num_devices, n_local), np.int64)
    owned_mask = np.zeros((num_devices, n_local), bool)
    face_ids = np.zeros((num_devices, f_local), np.int64)
    face_cells_local = np.zeros((num_devices, f_local, 2), np.int64)
    face_mask = np.zeros((num_devices, f_local), bool)
    face_flip = np.zeros((num_devices, f_local), bool)
    cell_device = np.zeros(n, np.int64)
    cell_slot = np.zeros(n, np.int64)

    g2l = np.full((num_devices, n), -1, np.int64)
    for d in range(num_devices):
        own, halo, fsel = locals_[d], halos[d], faces[d]
        local_cells[d, : len(own)] = own
        local_cells[d, n_owned_pad : n_owned_pad + len(halo)] = halo
        owned_mask[d, : len(own)] = True
        g2l[d, own] = np.arange(len(own))
        g2l[d, halo] = n_owned_pad + np.arange(len(halo))
        cell_device[own] = d
        cell_slot[own] = np.arange(len(own))
        # canonical orientation (local ascending) + canonical face
        # order (see _canonical_face_order): on uniform partitions of
        # rectilinear meshes every device then shares ONE static plan,
        # lighting up the gather-free banded Jacobian/face path under
        # shard_map (the per-rank BAIJ efficiency of the reference,
        # ode.F90:266-287)
        fc_d = face_cells[fsel]
        a_l = g2l[d][fc_d[:, 0]]
        b_l = g2l[d][fc_d[:, 1]]
        flip = a_l > b_l
        a_l, b_l = np.minimum(a_l, b_l), np.maximum(a_l, b_l)
        gh = is_ghost[fc_d[:, 0]] | is_ghost[fc_d[:, 1]]
        owned_both = (part[fc_d[:, 0]] == d) & (part[fc_d[:, 1]] == d)
        order = _canonical_face_order(a_l, b_l, gh, owned_both)
        fsel = fsel[order]
        face_ids[d, : len(fsel)] = fsel
        face_cells_local[d, : len(fsel), 0] = a_l[order]
        face_cells_local[d, : len(fsel), 1] = b_l[order]
        face_mask[d, : len(fsel)] = True
        face_flip[d, : len(fsel)] = flip[order]
        # pad faces point at slot 0 on both ends (zero-area, masked)
        face_cells_local[d, len(fsel) :] = 0

    # send buffers: device o sends each owned cell that is in someone's
    # halo exactly once; receivers index the flat gathered buffer
    send_lists = [[] for _ in range(num_devices)]
    send_pos = {}  # (owner, global cell) -> position in owner's buffer
    for d in range(num_devices):
        for g in halos[d]:
            o = part[g]
            key = (o, g)
            if key not in send_pos:
                send_pos[key] = len(send_lists[o])
                send_lists[o].append(g2l[o, g])
    num_send = max((len(s) for s in send_lists), default=0)
    num_send = max(num_send, 1)
    send_idx = np.zeros((num_devices, num_send), np.int64)
    for d, s in enumerate(send_lists):
        send_idx[d, : len(s)] = s
    recv_src = np.zeros((num_devices, n_halo), np.int64)
    for d in range(num_devices):
        for i, g in enumerate(halos[d]):
            o = part[g]
            recv_src[d, i] = o * num_send + send_pos[(o, g)]

    # --- point-to-point rounds: edge-color the neighbour digraph ------
    # edge (o -> d): cells d's halo needs from owner o. Greedy coloring
    # into rounds where every device sends <=1 and receives <=1 buffer
    # (a partial permutation; <= 2*max_degree - 1 rounds).
    edges = {}  # (o, d) -> (send local slots on o, recv halo slots on d)
    for d in range(num_devices):
        for i, g in enumerate(halos[d]):
            o = part[g]
            s, r = edges.setdefault((o, d), ([], []))
            s.append(g2l[o, g])
            r.append(n_owned_pad + i)
    out_used = [set() for _ in range(num_devices)]
    in_used = [set() for _ in range(num_devices)]
    edge_round = {}
    # larger edges first: keeps the padded buffer tight per round
    for (o, d), (s, _r) in sorted(
        edges.items(), key=lambda kv: -len(kv[1][0])
    ):
        r = 0
        while r in out_used[o] or r in in_used[d]:
            r += 1
        out_used[o].add(r)
        in_used[d].add(r)
        edge_round[(o, d)] = r
    n_rounds = max(edge_round.values(), default=-1) + 1
    s_edge = max((len(s) for s, _ in edges.values()), default=0) or 1
    n_rounds = max(n_rounds, 1)
    p2p_send = np.zeros((num_devices, n_rounds, s_edge), np.int64)
    p2p_recv = np.full((num_devices, n_rounds, s_edge), n_local, np.int64)
    perms = [[] for _ in range(n_rounds)]
    for (o, d), (s, rl) in edges.items():
        r = edge_round[(o, d)]
        p2p_send[o, r, : len(s)] = s
        p2p_recv[d, r, : len(rl)] = rl
        perms[r].append((o, d))
    p2p_perms = tuple(tuple(sorted(p)) for p in perms)

    return PartitionPlan(
        num_devices=num_devices,
        n_local=n_local,
        n_owned=n_owned,
        num_send=num_send,
        local_cells=local_cells.astype(np.int32),
        owned_mask=owned_mask,
        face_ids=face_ids.astype(np.int32),
        face_cells_local=face_cells_local.astype(np.int32),
        face_mask=face_mask,
        face_flip=face_flip,
        send_idx=send_idx.astype(np.int32),
        recv_src=recv_src.astype(np.int32),
        n_owned_pad=n_owned_pad,
        n_halo=n_halo,
        cell_device=cell_device.astype(np.int32),
        cell_slot=cell_slot.astype(np.int32),
        p2p_perms=p2p_perms,
        p2p_send=p2p_send.astype(np.int32),
        p2p_recv=p2p_recv.astype(np.int32),
    )
