"""Geometric partition of the mesh nodes (host numpy): the blocks of the
SSH preconditioner and the ranks of ``parallel/dist.py``.

Copies of ``_sphere_xyz`` and ``_partition_numpy`` from
``fesom2_tpu/parallel/partition.py:71-75, :139-160``: that module imports
the JAX package's mesh code, which imports jax.  ``ssh.build_block_schwarz``
cuts its preconditioner blocks with this plain weighted recursive
coordinate bisection (the JAX builder calls the same numpy function, not
the native partitioner), so both give the same blocks.
"""
from __future__ import annotations

import numpy as np


def _sphere_xyz(mesh):
    """Unit-sphere coordinates [N, 3] of the nodes' geographic lon/lat."""
    geo = mesh.geo_coords.detach().cpu().numpy()
    lon, lat = geo[:, 0], geo[:, 1]
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=1).copy()


def _partition_numpy(xyz, w, nparts):
    """Plain weighted recursive coordinate bisection: part id per node."""
    N = xyz.shape[0]
    part = np.zeros(N, np.int32)

    def bisect(idx, p0, np_):
        if np_ == 1:
            part[idx] = p0
            return
        np_left = np_ // 2
        frac = np_left / np_
        ext = xyz[idx].max(0) - xyz[idx].min(0)
        axis = int(np.argmax(ext))
        order = idx[np.argsort(xyz[idx, axis], kind="stable")]
        cw = np.cumsum(w[order])
        cut = int(np.searchsorted(cw, cw[-1] * frac)) + 1
        cut = max(1, min(cut, len(order) - 1))
        bisect(order[:cut], p0, np_left)
        bisect(order[cut:], p0 + np_left, np_ - np_left)

    bisect(np.arange(N), 0, nparts)
    return part


def node_weights(mesh) -> np.ndarray:
    """2D+3D balance weights, 1 + the node's levels (ref fort_part.c:90-95,
    PART_WEIGHTED; ``fesom2_tpu/parallel/partition.py:66-68``)."""
    return (1.0 + mesh.nlevels_node.detach().cpu().numpy()).astype(np.float64)


def partition_nodes(mesh, nparts: int) -> np.ndarray:
    """Part id per node [N] into ``nparts``: the weighted recursive
    coordinate bisection on the unit sphere.  The JAX package's
    ``partition_nodes`` refines its cut with Kernighan-Lin sweeps where its
    native library is built and falls back to this bisection where it is
    not; give ``build_layout`` the same ``part`` to compare the two."""
    return _partition_numpy(_sphere_xyz(mesh), node_weights(mesh), nparts)


def partition_nodes_hierarchical(mesh, n_part):
    """The two-level partition (``fesom2_tpu/parallel/partition.py:113-
    136``): the nodes into ``n_part[0]`` groups (hosts), each group into
    ``n_part[1]`` parts (cards); part id = host * n_part[1] + card.
    Returns (part [N], host [N])."""
    if isinstance(n_part, int):
        n_part = (1, n_part)
    hosts, chips = int(n_part[0]), int(n_part[1])
    top = partition_nodes(mesh, hosts)
    xyz = _sphere_xyz(mesh)
    w = node_weights(mesh)
    part = np.zeros(mesh.n_nodes, np.int32)
    for h in range(hosts):
        idx = np.nonzero(top == h)[0]
        if idx.size == 0:
            continue
        part[idx] = h * chips + _partition_numpy(xyz[idx], w[idx], chips)
    return part, top
