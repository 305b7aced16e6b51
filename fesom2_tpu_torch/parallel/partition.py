"""Domain decomposition of the node graph (host): the ranks of
``parallel/dist.py`` and the blocks of the SSH preconditioner.

The port of ``fesom2_tpu/parallel/partition.py`` (ref ``src/fort_part.c:
47-300``, PART_WEIGHTED: node weight = 1 + the node's levels; the
hierarchical levels of ``fvom_init.F90:1471``).  ``partition_nodes`` is
the weighted recursive coordinate bisection on the unit sphere with
Kernighan-Lin boundary sweeps of ``native/partitioner.cpp`` (the port's own
copy under ``fesom2_tpu_torch/native/``), which the JAX package takes by
default.  The host C++ compiler (``$CXX``, else ``g++``, else ``c++``)
builds it at first use into ``build/fesom2_tpu_torch/`` under a hash of
the source and flags, and ``ctypes`` loads it.  A failed build raises
with the compiler's output: there is no fallback, so the port's default
partition is always the JAX package's.

``_partition_numpy`` is the plain bisection without the sweeps.  The SSH
preconditioner's blocks (``core/ssh.py``) and the second level of the
hierarchical partition are cut with it, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..utils.support import host

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "partitioner.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fesom2_tpu_torch"
# the flags of native/Makefile, so that the sort and the sweeps are the
# same machine code as the JAX package's library
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_LIB = None


def find_cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler (CXX, g++, c++): the "
                       "partitioner cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfesom2_partitioner_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The path of the built partitioner, compiling it if needed; raises
    with the compiler's output where the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    cmd = [find_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("the partitioner did not build:\n" + " ".join(cmd)
                           + "\n" + res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        P = ctypes.POINTER
        lib.fesom_partition.restype = None
        lib.fesom_partition.argtypes = [
            ctypes.c_int, P(ctypes.c_int64), P(ctypes.c_int),
            P(ctypes.c_double), P(ctypes.c_double), ctypes.c_int,
            ctypes.c_int, P(ctypes.c_int)]
        lib.fesom_edge_cut.restype = ctypes.c_int64
        lib.fesom_edge_cut.argtypes = [
            ctypes.c_int, P(ctypes.c_int64), P(ctypes.c_int),
            P(ctypes.c_int)]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def node_graph_csr(mesh):
    """Symmetric node adjacency (every edge both ways) as CSR:
    (rowptr [N + 1] int64, colind int32)."""
    edges = host(mesh.edges).astype(np.int64)
    a = np.concatenate([edges[:, 0], edges[:, 1]])
    b = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    N = mesh.n_nodes
    counts = np.bincount(a, minlength=N)
    rowptr = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=rowptr[1:])
    return rowptr, b.astype(np.int32)


def node_weights(mesh) -> np.ndarray:
    """2D+3D balance weights, 1 + the node's levels (ref fort_part.c:90-95,
    PART_WEIGHTED)."""
    return (1.0 + host(mesh.nlevels_node)).astype(np.float64)


def _sphere_xyz(mesh) -> np.ndarray:
    """Unit-sphere coordinates [N, 3] of the nodes' geographic lon/lat."""
    geo = host(mesh.geo_coords)
    lon, lat = geo[:, 0], geo[:, 1]
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)], axis=1).copy()


def partition_nodes(mesh, nparts: int, refine_sweeps: int = 8) -> np.ndarray:
    """Part id per node [N] (int32) into ``nparts``: the weighted
    recursive coordinate bisection with ``refine_sweeps`` Kernighan-Lin
    sweeps at each cut (the JAX package's default partition)."""
    rowptr, colind = node_graph_csr(mesh)
    xyz = np.ascontiguousarray(_sphere_xyz(mesh))
    w = node_weights(mesh)
    part = np.zeros(mesh.n_nodes, np.int32)
    _load().fesom_partition(mesh.n_nodes, _ptr(rowptr, ctypes.c_int64),
                            _ptr(colind, ctypes.c_int),
                            _ptr(xyz, ctypes.c_double),
                            _ptr(w, ctypes.c_double), int(nparts),
                            int(refine_sweeps), _ptr(part, ctypes.c_int))
    return part


def edge_cut(mesh, part) -> int:
    """The number of mesh edges whose two nodes lie in different parts."""
    rowptr, colind = node_graph_csr(mesh)
    part = np.ascontiguousarray(part, np.int32)
    if part.shape != (mesh.n_nodes,):
        raise ValueError(f"part {part.shape}: one id per node "
                         f"({mesh.n_nodes})")
    return int(_load().fesom_edge_cut(mesh.n_nodes,
                                      _ptr(rowptr, ctypes.c_int64),
                                      _ptr(colind, ctypes.c_int),
                                      _ptr(part, ctypes.c_int)))


def partition_nodes_hierarchical(mesh, n_part, refine_sweeps: int = 8):
    """The two-level partition (ref &machine n_levels/n_part,
    gen_modules_config.F90:96-98): the nodes into ``n_part[0]`` groups
    (hosts) by ``partition_nodes``, each group into ``n_part[1]`` parts
    (cards) by the plain bisection; part id = host * n_part[1] + card.
    Returns (part [N], host [N])."""
    if isinstance(n_part, int):
        n_part = (1, n_part)
    hosts, chips = int(n_part[0]), int(n_part[1])
    top = partition_nodes(mesh, hosts, refine_sweeps)
    xyz = _sphere_xyz(mesh)
    w = node_weights(mesh)
    part = np.zeros(mesh.n_nodes, np.int32)
    for h in range(hosts):
        idx = np.nonzero(top == h)[0]
        if idx.size == 0:
            continue
        part[idx] = h * chips + _partition_numpy(xyz[idx], w[idx], chips)
    return part, top


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
