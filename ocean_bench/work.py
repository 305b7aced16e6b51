"""The yardstick's arithmetic: the card's peaks, each hand-written kernel's
least time from the bytes and operations of its launch, and the bytes a
whole step must move.

The ``*_work`` functions are the frozen copies under ``reference/fesom``
(each copied whole from the program at git e5ef625; the table ``WORK_FROM``
names the file and line of each original).  A launch is read as the
program's launcher received it (``kernels.launch(name, device, *args)``):
``launch_work`` maps its arguments to the function's, as the C signatures
of ``csrc/*.cu`` lay them out at that commit; a launch whose arguments no
longer fit that layout gives None, and ``kernels_roofline`` then reads
nothing.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from .reference.fesom.core import eos, ops, ssh, tracers
from .reference.fesom.core.mixing import kpp
from .reference.fesom.ice import evp
from .reference.fesom.ice.icepack import itd, thermo_vertical

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
# at the full 700 W): device memory bandwidth, and float64 / float32
# arithmetic outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12}

# where each counter was copied from (fesom2_tpu_torch/..., git e5ef625)
WORK_FROM = {
    "node_edge_reduce": "core/ops.py:223-231",
    "elem_to_node_mean": "core/ops.py:340-354",
    "elem_contrib_to_nodes": "core/ops.py:411-418",
    "tridiag_solve": "core/ops.py:501-507",
    "ring_spmv": "core/ssh.py:184-188",
    "block_schwarz": "core/ssh.py:554-570 (schwarz_stride, schwarz_tiles "
                     ":428-452)",
    "fct_bounds": "core/tracers.py:521-532",
    "pressure_bv": "core/eos.py:102-112",
    "kpp_column": "core/mixing/kpp.py:327-342",
    "mevp_subcycles": "ice/evp.py:245-256",
    "evp_subcycles": "ice/evp.py:696-706",
    "aevp_subcycles": "ice/evp.py:709-718",
    "bl99_temperature_solve": "ice/icepack/thermo_vertical.py:317-359",
    "itd_remap": "ice/icepack/itd.py:316-330",
}

# the CUDA functions of each hand-written kernel as the trace names them
# (csrc/*.cu at git e5ef625); longer names first, so that
# ``mevp_subcycles_kernel`` is not read as ``evp_subcycles_kernel``
CUDA_NAMES = (
    ("mevp_subcycles_kernel", "mevp_subcycles"),
    ("aevp_subcycles_kernel", "aevp_subcycles"),
    ("evp_subcycles_kernel", "evp_subcycles"),
    ("node_edge_reduce", "node_edge_reduce"),
    ("elem_to_node_mean", "elem_to_node_mean"),
    ("elem_contrib_to_nodes", "elem_contrib_to_nodes"),
    ("tridiag_solve_kernel", "tridiag_solve"),
    ("fct_bounds_kernel", "fct_bounds"),
    ("ring_spmv_", "ring_spmv"),
    ("schwarz_local_kernel", "block_schwarz"),
    ("schwarz_combine_kernel", "block_schwarz"),
    ("pressure_bv_kernel", "pressure_bv"),
    ("kpp_column_kernel", "kpp_column"),
    ("bl99_kernel", "bl99_temperature_solve"),
    ("itd_remap_kernel", "itd_remap"),
    ("dens_moc_bin_kernel", "dens_moc_bin"),
    ("window_gather_kernel", "window_gather"),
    ("onehot_gather_kernel", "onehot_gather"),
)
_CUDA_RE = [(re.compile(r"(?<![A-Za-z0-9_])" + re.escape(k)), v)
            for k, v in CUDA_NAMES]


def kernel_of(cuda_name: str) -> Optional[str]:
    """The hand-written kernel a traced CUDA function belongs to, or None
    (a library's kernel)."""
    for pat, name in _CUDA_RE:
        if pat.search(cuda_name):
            return name
    return None


def least_s(nbytes: float, flops: float, itemsize: int) -> float:
    """The card's least seconds for that many bytes and operations."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[itemsize])


def _item(t) -> int:
    return t.element_size()


def _wet(nlevels: torch.Tensor, ulevels=None) -> int:
    """Wet layers of columns with these level counts (interfaces), read
    once the profiled steps are over (the tables are static)."""
    n = nlevels.long()
    top = 1 if ulevels is None else ulevels.long()
    return int((n - top).clamp_min(0).sum())


def launch_work(name: str, entry: str, args: tuple) -> Optional[tuple]:
    """(bytes, flops, itemsize) of one launch, or None where the arguments
    do not fit the kernel's layout at git e5ef625."""
    try:
        return _launch_work(name, entry, args)
    except (IndexError, AttributeError, TypeError, KeyError, ValueError):
        return None


def _launch_work(name, entry, a):
    if name == "node_edge_reduce":
        f, R, Ed, slot, N, KE = a[:6]
        pair = bool(a[9])
        return (*ops.node_edge_reduce_work(R, Ed, N, KE, pair, _item(f)),
                _item(f))
    if name == "elem_to_node_mean" and entry == "_flat":
        xf, R, E, nie, N, K = a[:6]
        return (*ops.elem_to_node_mean_work(R, 1, E, N, K, _item(xf)),
                _item(xf))
    if name == "elem_to_node_mean":
        xf, R, levels, E, N, K = a[:6]
        tile_elems, tile_nodes = a[9], a[10]
        return (*ops.elem_to_node_mean_work(R, levels, E, N, K, _item(xf),
                                            tile_elems.numel(), tile_nodes),
                _item(xf))
    if name == "elem_contrib_to_nodes":
        flat, R, E, slot, N, K = a[:6]
        return (*ops.elem_contrib_to_nodes_work(R, E, N, K, _item(flat)),
                _item(flat))
    if name == "tridiag_solve":
        df, B, L, X = a[3:7]
        return (*ops.tridiag_solve_work(B, L, X, _item(df)), _item(df))
    if name == "ring_spmv":
        x, Kr, N = a[2:5]
        return (*ssh.ring_spmv_work(Kr, N, _item(x)), _item(x))
    if name == "block_schwarz":
        r, N, row_off, S, Kc = a[0], a[1], a[4], a[12], a[14]
        sizes = np.diff(row_off.cpu().numpy())
        return (*ssh.block_schwarz_packed_work(N, sizes, S, Kc, _item(r)),
                _item(r))
    if name == "fct_bounds":
        ttf, T, L, N, M = a[0], a[2], a[3], a[4], a[5]
        tile_nodes_list, tile_nodes = a[10], a[11]
        return (*tracers.fct_bounds_work(T, L, N, M, _item(ttf),
                                         tile_nodes_list.numel(),
                                         tile_nodes), _item(ttf))
    if name == "pressure_bv":
        t, nlev, ulev, L1, N, kind = a[0], a[6], a[7], a[8], a[9], a[10]
        return (*eos.pressure_bv_work(L1 - 1, N, _wet(nlev, ulev), kind,
                                      _item(t)), _item(t))
    if name == "kpp_column":
        u, nlev, nl, N, dd = a[0], a[14], a[15], a[16], a[17]
        return (*kpp.kpp_column_work(nl, N, _wet(nlev), bool(dd), _item(u)),
                _item(u))
    if name in ("mevp_subcycles", "evp_subcycles", "aevp_subcycles"):
        uv, N, E, K, n = a[0], a[7], a[8], a[9], a[10]
        fn = getattr(evp, name + "_work")
        return (*fn(N, E, K, _item(uv), n), _item(uv))
    if name == "bl99_temperature_solve":
        # the sweeps a call makes depend on the data: counted here as none,
        # so the least time is the bytes' (with the final fluxes' operations)
        hi, shcoef = a[0], a[12]
        ncat, N, ni, ns, conduct = a[-11], a[-10], a[-9], a[-8], a[-6]
        cond = {v: k for k, v in thermo_vertical.CONDUCT.items()}[conduct]
        return (*thermo_vertical.temperature_solve_work(
            ncat, N, ni, ns, _item(hi), 0, shcoef is not None, cond),
            _item(hi))
    if name == "itd_remap":
        out = a[8]
        ncat, rows, N = out.shape
        linear = bool(a[-2])
        return (*itd.itd_remap_work(ncat, rows, N, _item(out), linear),
                _item(out))
    return None


def step_state_bytes(sizes: dict, n_tracers: int, icepack) -> int:
    """Bytes any implementation of one coupled step must move: the state
    carried from step to step read once and written once, and one record of
    the forcing read once.  Per wet node-level: each tracer and its previous
    level, and the layer thickness; per wet element-level: u, v and the
    element thickness; per wet node-interface: w; per node: eta, hbar, the
    ice's area, mass, snow, velocity and skin temperature; per element: the
    ice stresses; under Icepack, per node and category: area, volume, snow,
    surface temperature and the layers' enthalpies.  The forcing: nine
    atmospheric fields a node.  Sizes are the configuration's
    (``check.mesh_sizes``), never the program's arrays."""
    item = sizes["itemsize"]
    cells = ((2 * n_tracers + 1) * sizes["wet_node_levels"]
             + 3 * sizes["wet_elem_levels"]
             + sizes["wet_node_interfaces"]
             + 8 * sizes["n_nodes"] + 3 * sizes["n_elems"])
    if icepack:
        cells += sizes["n_nodes"] * icepack["ncat"] * (
            4 + icepack["nilyr"] + icepack["nslyr"])
    return item * (2 * cells + 9 * sizes["n_nodes"])
