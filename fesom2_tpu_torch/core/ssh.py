"""Semi-implicit free surface: operator, rhs, dense solve, hbar update.

The port of the dense-solve subset of ``fesom2_tpu/core/ssh.py``.  The
operator (ref init_stiff_mat_ale, ``src/oce_ale.F90:1088-1354``) is

    A(eta) = eta * areasvol(surface)/dt + g*dt*alpha*theta * D(H * G(eta))

with G the elemental scalar gradient, H the element depth and D the
edge-stencil divergence.  For meshes up to ``model.DENSE_SSH_MAX_NODES``
nodes the inverse is precomputed on the host and the solve is one product
with it plus one refinement sweep.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fesom2_tpu.constants import g
from ..mesh import MeshTables
from .ops import scalar_gradient, edge_divergence, edge_transport
from .state import OceanState, Forcing


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def elem_depth(mesh: MeshTables):
    """zbar_e_bot - zbar_e_srf: negative total unperturbed element depth."""
    return mesh.zbar_e_bot - mesh.zbar[(mesh.ulevels_elem - 1).long()]


def _edge_stencil_flux(field_gx, field_gy, H_el, mesh: MeshTables):
    """Per-edge flux s1+s2 of the SSH stencil (ref :1202-1258 pattern)."""
    et1, et2 = mesh.edge_tri[:, 0], mesh.edge_tri[:, 1]
    has2 = et2 >= 0
    et2s = torch.where(has2, et2, 0)
    dX1, dY1 = mesh.edge_cross_dxdy[:, 0], mesh.edge_cross_dxdy[:, 1]
    dX2, dY2 = mesh.edge_cross_dxdy[:, 2], mesh.edge_cross_dxdy[:, 3]
    s1 = H_el[et1] * (field_gx[et1] * dY1 - field_gy[et1] * dX1)
    s2 = torch.where(
        has2, -H_el[et2s] * (field_gx[et2s] * dY2 - field_gy[et2s] * dX2), 0.0)
    return s1 + s2


def _surface_areasvol(mesh: MeshTables):
    return torch.gather(mesh.areasvol, 0,
                        (mesh.ulevels_node - 1).long()[None, :])[0]


def ssh_operator(mesh: MeshTables, cfg):
    """The matrix-free SPD operator eta -> A(eta) (linfs: static depth)."""
    dt = cfg.dt
    factor = g * dt * cfg.dyn.alpha * cfg.dyn.theta
    H = elem_depth(mesh)
    diag_mass = _surface_areasvol(mesh) / dt

    def op(eta):
        gx, gy = scalar_gradient(eta, mesh)
        flux = _edge_stencil_flux(gx, gy, H, mesh)
        return eta * diag_mass + factor * edge_divergence(flux, mesh)

    return op


def ssh_dense_matrix(mesh: MeshTables, cfg) -> np.ndarray:
    """The SSH operator as a dense [N, N] numpy matrix (host side)."""
    N = mesh.n_nodes
    edges = _np(mesh.edges)
    etri = _np(mesh.edge_tri)
    en = _np(mesh.elem_nodes)
    gsca = _np(mesh.gradient_sca)
    ecd = _np(mesh.edge_cross_dxdy)
    zbar = _np(mesh.zbar)
    H = _np(mesh.zbar_e_bot) - zbar[_np(mesh.ulevels_elem) - 1]
    dt = cfg.dt
    factor = g * dt * cfg.dyn.alpha * cfg.dyn.theta

    A = np.zeros((N, N))
    avn = _np(mesh.areasvol)
    uln0 = _np(mesh.ulevels_node) - 1
    np.fill_diagonal(A, avn[uln0, np.arange(N)] / dt)
    for i in range(2):
        el = etri[:, i]
        ok = el >= 0
        els = np.where(ok, el, 0)
        dX = ecd[:, 2 * i]
        dY = ecd[:, 2 * i + 1]
        sgn = 1.0 if i == 0 else -1.0
        for k in range(3):
            fy = H[els] * (gsca[els, k] * dY - gsca[els, k + 3] * dX) * sgn
            fy = np.where(ok, fy * factor, 0.0)
            col = en[els, k]
            for j, rsgn in ((0, 1.0), (1, -1.0)):
                np.add.at(A, (edges[:, j], col), rsgn * fy)
    return A


def ssh_dense_inverse(mesh: MeshTables, cfg, dtype=torch.float64):
    """Dense inverse of the SSH operator, on the mesh's device."""
    A = ssh_dense_matrix(mesh, cfg)
    dead = np.abs(A).sum(1) == 0        # padded rows: identity, then zero
    A[dead, dead] = 1.0
    Ainv = np.linalg.inv(A)
    Ainv[dead, :] = 0.0
    Ainv[:, dead] = 0.0
    return torch.as_tensor(Ainv, device=mesh.zbar.device).to(dtype)


def solve_ssh_dense(state: OceanState, mesh: MeshTables, cfg, dense_inv, rhs,
                    n_refine: int = 1):
    """d_eta = A^-1 rhs by a product with the dense inverse plus
    ``n_refine`` sweeps of iterative refinement against the operator.
    Returns (d_eta, number of products); the step needs no residual, so
    ``ssh_relative_residual`` computes it apart for callers that ask."""
    if cfg.ale.which_ALE != "linfs":
        raise NotImplementedError("the hbar-corrected zstar/zlevel operator "
                                  "is not ported yet: ROADMAP queue 1 item 8")
    op = ssh_operator(mesh, cfg)
    x = dense_inv @ rhs
    for _ in range(n_refine):
        x = x + dense_inv @ (rhs - op(x))
    return x, 1 + n_refine


def ssh_relative_residual(mesh: MeshTables, cfg, d_eta, rhs) -> torch.Tensor:
    """|rhs - A d_eta| / |rhs| for the SSH operator."""
    r = rhs - ssh_operator(mesh, cfg)(d_eta)
    return torch.linalg.norm(r) / (torch.linalg.norm(rhs) + 1e-300)


def ssh_matrix_diagonal(mesh: MeshTables, cfg) -> torch.Tensor:
    """Exact diagonal of the assembled operator (host-side numpy, ref
    init_stiff_mat_ale :1202-1270 keeping col == row)."""
    edges = _np(mesh.edges)
    etri = _np(mesh.edge_tri)
    en = _np(mesh.elem_nodes)
    gsca = _np(mesh.gradient_sca)
    ecd = _np(mesh.edge_cross_dxdy)
    zbar = _np(mesh.zbar)
    H = _np(mesh.zbar_e_bot) - zbar[_np(mesh.ulevels_elem) - 1]
    dt = cfg.dt
    factor = g * dt * cfg.dyn.alpha * cfg.dyn.theta
    avn = _np(mesh.areasvol)
    uln0 = _np(mesh.ulevels_node) - 1
    diag = (avn[uln0, np.arange(avn.shape[1])] / dt).copy()
    for i in range(2):
        el = etri[:, i]
        ok = el >= 0
        els = np.where(ok, el, 0)
        dX = ecd[:, 2 * i]
        dY = ecd[:, 2 * i + 1]
        sgn = 1.0 if i == 0 else -1.0
        for k in range(3):
            fy = np.where(ok, H[els] * (gsca[els, k] * dY
                                        - gsca[els, k + 3] * dX) * sgn, 0.0)
            node_k = en[els, k]
            for j, rsgn in ((0, 1.0), (1, -1.0)):
                row = edges[:, j]
                np.add.at(diag, row, np.where(node_k == row,
                                              rsgn * fy * factor, 0.0))
    return torch.as_tensor(diag, device=mesh.zbar.device).to(mesh.zbar.dtype)


def compute_ssh_rhs(state: OceanState, mesh: MeshTables, cfg, forcing: Forcing,
                    u_rhs, v_rhs):
    """ssh_rhs = -alpha*div(int (u+du) dz) + (1-alpha)*ssh_rhs_old (linfs;
    ref compute_ssh_rhs_ale :1478)."""
    if cfg.ale.which_ALE != "linfs":
        raise NotImplementedError("zstar/zlevel SSH rhs: ROADMAP queue 1 "
                                  "item 8")
    alpha = cfg.dyn.alpha
    he = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    c = alpha * edge_transport((state.u + u_rhs) * he,
                               (state.v + v_rhs) * he, mesh).sum(0)
    return edge_divergence(c, mesh) + (1.0 - alpha) * state.ssh_rhs_old


def compute_hbar(state: OceanState, mesh: MeshTables, cfg,
                 forcing: Forcing) -> OceanState:
    """hbar(n+1/2) update (ref compute_hbar_ale :1585-1676), linfs."""
    if cfg.ale.which_ALE != "linfs":
        raise NotImplementedError("zstar/zlevel hbar: ROADMAP queue 1 item 8")
    he = torch.where(mesh.elem_layer_mask, state.helem, 0.0)
    c = edge_transport(state.u * he, state.v * he, mesh).sum(0)
    rhs_old = edge_divergence(c, mesh)
    av_srf = _surface_areasvol(mesh)
    hbar = state.hbar + rhs_old * cfg.dt / torch.where(av_srf > 0, av_srf, 1.0)
    return replace(state, hbar=hbar, hbar_old=state.hbar, ssh_rhs_old=rhs_old)
