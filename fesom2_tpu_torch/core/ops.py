"""Core mesh operators: gathers, edge/node assembly, gradients, column solves.

The port of ``fesom2_tpu/core/ops.py``.  Layout is levels-major
``[nl(-1), X]`` with X the nodes, elements or edges; index tables are the
mesh's int32 tables padded with -1, and every padded index is clamped or
skipped before it is read.

Three operators run a hand-written CUDA kernel on a CUDA tensor
(``csrc/``): ``edge_divergence`` and ``edge_signed_reduce2``
(node_edge_reduce), ``elem_to_node_mean`` and ``elem_to_node_mean_flat``
(elem_to_node_mean), ``tridiag_solve``.  Beside each is its plain torch
version (``*_plain``), which the wrapper uses for a CPU tensor and nowhere
else: a CUDA tensor goes through the kernel or the call raises.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..mesh import MeshTables


def _flat_rows(x: torch.Tensor) -> torch.Tensor:
    """[..., X] -> contiguous [R, X]."""
    return x.reshape(-1, x.shape[-1]).contiguous()


# --------------------------------------------------------------------------
# gathers
# --------------------------------------------------------------------------
def take_row(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-column row gather: a[..., L, N] at row idx[N] -> [..., N]."""
    ib = idx.long().expand(a.shape[:-2] + (1, idx.shape[-1]))
    return torch.gather(a, -2, ib)[..., 0, :]


def elem_mean_node(x: torch.Tensor, mesh: MeshTables) -> torch.Tensor:
    """Average a node field to elements: [.., N] -> [.., E]."""
    return x[..., mesh.elem_nodes].mean(-1)


def edge_transport(uh: torch.Tensor, vh: torch.Tensor,
                   mesh: MeshTables) -> torch.Tensor:
    """Per-edge transport through the two centroid-to-midpoint segments:
    ``c = (vh|et1*dX1 - uh|et1*dY1) - (vh|et2*dX2 - uh|et2*dY2)``
    (ref oce_ale.F90:1724-1780).  Callers pass level-masked uh, vh."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    c1 = vh[..., et1] * dX1 - uh[..., et1] * dY1
    c2 = torch.where(has2, -(vh[..., et2s] * dX2 - uh[..., et2s] * dY2), 0.0)
    return c1 + c2


def scalar_gradient(f_nodes: torch.Tensor, mesh: MeshTables):
    """Gradient of a node scalar on elements: [.., N] -> (gx, gy) [.., E]
    (ref tracer_gradient_elements, oce_tracer_mod.F90:19-45)."""
    fe = f_nodes[..., mesh.elem_nodes]                      # [.., E, 3]
    gx = (fe * mesh.gradient_sca[:, 0:3]).sum(-1)
    gy = (fe * mesh.gradient_sca[:, 3:6]).sum(-1)
    return gx, gy


# --------------------------------------------------------------------------
# edge -> node assembly (kernel node_edge_reduce)
# --------------------------------------------------------------------------
def _signed_edge_values(flux: torch.Tensor, mesh: MeshTables):
    """sign * flux at each node's incident edges: [.., KE, N]."""
    ne = mesh.node_edges.T                                  # [KE, N]
    valid = ne >= 0
    safe = torch.where(valid, ne, 0)
    sign = torch.where(valid, mesh.node_edge_sign.T, 0.0)
    return flux[..., safe] * sign


def edge_divergence_plain(flux: torch.Tensor, mesh: MeshTables):
    return _signed_edge_values(flux, mesh).sum(-2)


def edge_signed_reduce2_plain(flux: torch.Tensor, mesh: MeshTables):
    vals = _signed_edge_values(flux, mesh)
    return vals.clamp_min(0.0).sum(-2), vals.clamp_max(0.0).sum(-2)


def _node_edge_reduce(flux: torch.Tensor, mesh: MeshTables, pair: bool):
    kernels.cuda_only(flux, "node_edge_reduce")
    f = _flat_rows(flux)
    R, Ed = f.shape
    N, KE = mesh.node_edges.shape
    dev, dt = flux.device, flux.dtype
    kernels.require(f, "flux", (R, mesh.n_edges), dt, dev)
    kernels.require(mesh.node_edges, "node_edges", (N, KE), torch.int32, dev)
    kernels.require(mesh.node_edge_sign, "node_edge_sign", (N, KE), dt, dev)
    out0 = torch.empty((R, N), dtype=dt, device=dev)
    out1 = torch.empty((R, N), dtype=dt, device=dev) if pair else None
    kernels.launch("node_edge_reduce", dev, f, R, Ed, mesh.node_edges,
                   mesh.node_edge_sign, N, KE, out0, out1, int(pair),
                   kernels.float_code(dt))
    shape = flux.shape[:-1] + (N,)
    if pair:
        return out0.reshape(shape), out1.reshape(shape)
    return out0.reshape(shape)


def edge_divergence(flux: torch.Tensor, mesh: MeshTables) -> torch.Tensor:
    """Per-node divergence of signed edge fluxes: flux[.., Ed] counted
    positive INTO edges[:,0]; returns [.., N] (+flux at node0, -flux at
    node1; ref ssh_rhs(enodes(1))+=c, oce_ale.F90:1542).  Gathered over
    the node->edge incidence table, no scatter."""
    if flux.device.type == "cpu":
        return edge_divergence_plain(flux, mesh)
    return _node_edge_reduce(flux, mesh, pair=False)


def edge_signed_reduce2(flux: torch.Tensor, mesh: MeshTables):
    """(plus, minus) sums of max(0, sign*flux) and min(0, sign*flux) over
    each node's incident edges, from one pass (the FCT b1 pair, ref
    oce_adv_tra_fct.F90:215-263)."""
    if flux.device.type == "cpu":
        return edge_signed_reduce2_plain(flux, mesh)
    return _node_edge_reduce(flux, mesh, pair=True)


# --------------------------------------------------------------------------
# element -> node averaging (kernel elem_to_node_mean)
# --------------------------------------------------------------------------
def _nie_weights(mesh: MeshTables):
    nie = mesh.nod_in_elem                                  # [N, K]
    valid = nie >= 0
    safe = torch.where(valid, nie, 0)
    w = torch.where(valid, mesh.elem_area[safe], 0.0)       # [N, K]
    return safe, w


def elem_to_node_mean_plain(x_elem: torch.Tensor, mesh: MeshTables,
                            respect_levels: bool = True) -> torch.Tensor:
    safe, w = _nie_weights(mesh)
    xv = x_elem[..., safe]                                  # [.., L, N, K]
    if respect_levels:
        wl = torch.where(mesh.elem_layer_mask[..., safe], w, 0.0)
    else:
        wl = w.expand(xv.shape)
    return (xv * wl).sum(-1) / (wl.sum(-1)).clamp_min(1e-30)


def elem_to_node_mean_flat_plain(xs: torch.Tensor,
                                 mesh: MeshTables) -> torch.Tensor:
    safe, w = _nie_weights(mesh)
    return (xs[..., safe] * w).sum(-1) / w.sum(-1)


def _elem_to_node_mean_kernel(x: torch.Tensor, mesh: MeshTables,
                              levels: int, mask) -> torch.Tensor:
    kernels.cuda_only(x, "elem_to_node_mean")
    dev, dt = x.device, x.dtype
    E = mesh.n_elems
    N, K = mesh.nod_in_elem.shape
    xf = x.reshape(-1, levels, E).contiguous()
    R = xf.shape[0]
    kernels.require(xf, "x_elem", (R, levels, E), dt, dev)
    kernels.require(mesh.nod_in_elem, "nod_in_elem", (N, K), torch.int32, dev)
    kernels.require(mesh.elem_area, "elem_area", (E,), dt, dev)
    if mask is not None:
        kernels.require(mask, "elem_layer_mask", (levels, E), torch.bool, dev)
    out = torch.empty((R, levels, N), dtype=dt, device=dev)
    kernels.launch("elem_to_node_mean", dev, xf, R, levels, E,
                   mesh.nod_in_elem, N, K, mesh.elem_area, mask, out,
                   kernels.float_code(dt))
    return out.reshape(x.shape[:-1] + (N,))


def elem_to_node_mean(x_elem: torch.Tensor, mesh: MeshTables,
                      respect_levels: bool = True) -> torch.Tensor:
    """Area-weighted average of a layered element field to nodes:
    [.., nl-1, E] -> [.., nl-1, N].  With ``respect_levels`` only elements
    active on the layer contribute (compute_vel_nodes, oce_dyn.F90:133-169);
    without, all adjacent elements do (visc_filt_bcksct, :619-635)."""
    if x_elem.device.type == "cpu":
        return elem_to_node_mean_plain(x_elem, mesh, respect_levels)
    L = x_elem.shape[-2]
    return _elem_to_node_mean_kernel(
        x_elem, mesh, L, mesh.elem_layer_mask if respect_levels else None)


def elem_to_node_mean_flat(xs: torch.Tensor, mesh: MeshTables) -> torch.Tensor:
    """Stacked surface element fields [F, E] -> [F, N], area-weighted over
    all adjacent elements (no level masks)."""
    if xs.device.type == "cpu":
        return elem_to_node_mean_flat_plain(xs, mesh)
    return _elem_to_node_mean_kernel(xs, mesh, 1, None)


# --------------------------------------------------------------------------
# vertical (column) solvers (kernel tridiag_solve)
# --------------------------------------------------------------------------
def tridiag_solve_plain(a, b, c, d):
    L = d.shape[-2]
    cp = torch.empty(torch.broadcast_shapes(a.shape, d.shape),
                     dtype=d.dtype, device=d.device)
    dp = torch.empty_like(cp)
    cp_prev = dp_prev = torch.zeros_like(cp[..., 0, :])
    for k in range(L):
        a_, b_, c_, d_ = a[..., k, :], b[..., k, :], c[..., k, :], d[..., k, :]
        m = b_ - cp_prev * a_
        cp[..., k, :] = c_ / m
        dp[..., k, :] = (d_ - dp_prev * a_) / m
        cp_prev, dp_prev = cp[..., k, :], dp[..., k, :]
    x = torch.empty_like(dp)
    x_next = torch.zeros_like(dp[..., 0, :])
    for k in range(L - 1, -1, -1):
        x[..., k, :] = dp[..., k, :] - cp[..., k, :] * x_next
        x_next = x[..., k, :]
    return x


def tridiag_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """Thomas algorithm over the level axis: tridiag(a, b, c) x = d.

    a (sub-), b (main), c (super-diagonal) are [L, X] (the plain version
    also broadcasts them batched like d, as the JAX function does; the
    kernel takes [L, X] only); d is [L, X] or [B, L, X].  Rows outside a
    column's active range must be identity rows (a=c=0, b=1, d=0), as the
    caller prepares them.
    """
    if d.device.type == "cpu":
        return tridiag_solve_plain(a, b, c, d)
    kernels.cuda_only(d, "tridiag_solve")
    dev, dt = d.device, d.dtype
    L, X = d.shape[-2:]
    df = d.reshape(-1, L, X).contiguous()
    B = df.shape[0]
    abc = [t.contiguous() for t in (a, b, c)]
    for name, t in zip("abc", abc):
        kernels.require(t, name, (L, X), dt, dev)
    cp = torch.empty_like(df)
    x = torch.empty_like(df)
    kernels.launch("tridiag_solve", dev, abc[0], abc[1], abc[2], df, B, L, X,
                   cp, x, kernels.float_code(dt))
    return x.reshape(d.shape)


def cumsum_bottom_up(x: torch.Tensor) -> torch.Tensor:
    """out[k] = sum_{j>=k} x[j] along axis 0 (ref oce_ale.F90:1789-1799)."""
    return torch.flip(torch.cumsum(torch.flip(x, (0,)), 0), (0,))
