"""Top-level model: setup and the ocean step, on one device.

The port of the soufflet path of ``fesom2_tpu/model.py``: the step mirrors
the reference orchestrator ``oce_timestep_ale`` (``src/oce_ale.F90:
2521-2799``) with the per-step pre-phase of ``fvom_main.F90:199-268``.
``Model`` is an ``nn.Module`` whose buffers are the static tables (mesh,
tracer and soufflet statics, reference density, dense SSH inverse); the
step runs eagerly on the device those buffers live on.

Configurations outside the ported slice (linfs, linear EoS, PP mixing,
visc_option=5, mom_adv=2, MUSCL/QR4C/FCT, dense SSH solve) raise
NotImplementedError naming the ROADMAP item that will port them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from fesom2_tpu.config import ModelConfig
from .mesh import MeshTables, build_mesh, build_mesh_from_raw
from .mesh.channel import channel_raw_mesh
from .core import eos, dynamics, ssh, ale, tracers
from .core.ops import edge_divergence, take_row
from .core.state import (OceanState, Forcing, allocate_state,
                         init_thickness_linfs)
from .core.tracer_setup import TracerStatics, build_tracer_statics
from .core.mixing import pp as pp_mixing
from .toy import soufflet

# meshes up to this size solve SSH with a precomputed dense inverse
DENSE_SSH_MAX_NODES = 16384


def check_slice(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for every configuration branch the port
    does not have yet, naming its ROADMAP item."""
    missing = []
    if not (cfg.run.toy_ocean and cfg.run.which_toy == "soufflet"):
        missing.append("configurations other than the soufflet channel "
                       "(queue 1 items 8-14)")
    if cfg.run.use_ice or cfg.run.use_sw_pene:
        missing.append("ice and shortwave penetration (items 10-11)")
    if cfg.run.use_cavity:
        missing.append("ice-shelf cavities (item 15)")
    if cfg.ale.which_ALE != "linfs":
        missing.append(f"which_ALE='{cfg.ale.which_ALE}' (item 8)")
    if cfg.ale.use_partial_cell:
        missing.append("partial bottom cells (item 8)")
    if [s.strip().upper() for s in cfg.dyn.mix_scheme.split("+")] != ["PP"]:
        missing.append(f"mix_scheme='{cfg.dyn.mix_scheme}' (KPP item 9, "
                       "CVMix item 16)")
    if cfg.dyn.visc_option != 5:
        missing.append(f"visc_option={cfg.dyn.visc_option} (item 15)")
    if cfg.dyn.mom_adv != 2:
        missing.append(f"mom_adv={cfg.dyn.mom_adv} (item 15)")
    if not cfg.dyn.i_vert_visc or not cfg.tra.i_vert_diff:
        missing.append("explicit vertical viscosity/diffusion (item 15)")
    if cfg.dyn.w_split:
        missing.append("w_split (item 8)")
    if cfg.dyn.Fer_GM or cfg.dyn.Redi:
        missing.append("GM/Redi (item 10)")
    if cfg.dyn.SPP:
        missing.append("salt plume (item 15)")
    if cfg.diag.ldiag_DVD:
        missing.append("the DVD diagnostic (item 20)")
    if cfg.tra.num_tracers != 2 or list(cfg.tra.tracer_ID[:2]) != [0, 1]:
        missing.append("passive tracers (item 15)")
    if cfg.tra.clim_relax > 1e-8:
        missing.append("relaxation to climatology (item 19)")
    if (cfg.tra.tra_adv_hor, cfg.tra.tra_adv_ver, cfg.tra.tra_adv_lim) \
            != ("MUSCL", "QR4C", "FCT"):
        missing.append("tracer schemes other than MUSCL/QR4C/FCT (items "
                       "10 and 15)")
    if cfg.tra.double_diffusion or cfg.dyn.use_kpp_nonlclflx:
        missing.append("KPP double diffusion and nonlocal fluxes (item 9)")
    if cfg.tra.use_momix:
        missing.append("Monin-Obukhov mixing (item 15)")
    if missing:
        raise NotImplementedError("not ported yet (ROADMAP): "
                                  + "; ".join(missing))


class Model(nn.Module):
    """The static tables of one configuration, as buffers, and its step."""

    def __init__(self, mesh: MeshTables, cfg: ModelConfig,
                 tracer_statics: TracerStatics, density_ref: torch.Tensor,
                 soufflet_statics: soufflet.SouffletStatics,
                 ssh_dense_inv: torch.Tensor):
        super().__init__()
        check_slice(cfg)
        self.cfg = cfg
        self._static = {}
        for prefix, obj in (("mesh", mesh), ("st", tracer_statics),
                            ("sst", soufflet_statics)):
            statics = {}
            for f in dataclasses.fields(obj):
                val = getattr(obj, f.name)
                if isinstance(val, torch.Tensor):
                    self.register_buffer(f"{prefix}__{f.name}", val)
                else:
                    statics[f.name] = val
            self._static[prefix] = statics
        self.register_buffer("density_ref", density_ref)
        self.register_buffer("ssh_dense_inv", ssh_dense_inv)

    def _group(self, prefix: str, cls):
        tensors = {f.name: getattr(self, f"{prefix}__{f.name}")
                   for f in dataclasses.fields(cls)
                   if f.name not in self._static[prefix]}
        return cls(**tensors, **self._static[prefix])

    @property
    def mesh(self) -> MeshTables:
        return self._group("mesh", MeshTables)

    @property
    def tracer_statics(self) -> TracerStatics:
        return self._group("st", TracerStatics)

    @property
    def soufflet_statics(self) -> soufflet.SouffletStatics:
        return self._group("sst", soufflet.SouffletStatics)

    @property
    def dtype(self):
        return self.density_ref.dtype

    # ------------------------------------------------------------------
    def initial_state(self) -> OceanState:
        mesh = self.mesh
        state = allocate_state(mesh, self.cfg.tra.num_tracers, self.dtype)
        state = init_thickness_linfs(state, mesh)
        T, U, _ = soufflet.setup_soufflet(mesh, self.dtype)
        tr = state.tr.clone()
        tr[0] = T
        tr[1] = torch.where(mesh.node_layer_mask, 35.0, 0.0)
        return replace(state, tr=tr, tr_old=tr, u=U)

    # ------------------------------------------------------------------
    def forward(self, state: OceanState, forcing: Forcing) -> OceanState:
        """One ocean step (ref oce_timestep_ale).  The named spans mark the
        step's layers for torch.profiler; they cost about a microsecond
        each when no profiler runs."""
        cfg = self.cfg
        sst = self.soufflet_statics
        mesh = replace(self.mesh, coriolis=sst.coriolis)
        st = self.tracer_statics

        with record_function("step.prephase"):
            state = dynamics.compute_vel_nodes(state, mesh)
            state = eos.pressure_bv(state, mesh, cfg, self.density_ref)
            state = dynamics.pressure_force(state, mesh, cfg)
            state = pp_mixing.oce_mixing_pp(state, mesh, cfg)
            state = pp_mixing.mo_convect(state, mesh, cfg, forcing)

        with record_function("step.momentum"):
            state, u_rhs, v_rhs = dynamics.compute_vel_rhs(state, mesh,
                                                           forcing, cfg)
            state, u_rhs, v_rhs = dynamics.viscosity_filter(state, mesh, cfg,
                                                            u_rhs, v_rhs)
            u_rhs, v_rhs = dynamics.impl_vert_visc(state, mesh, cfg, forcing,
                                                   u_rhs, v_rhs)

        with record_function("step.ssh"):
            rhs = ssh.compute_ssh_rhs(state, mesh, cfg, forcing, u_rhs, v_rhs)
            d_eta, _ = ssh.solve_ssh_dense(state, mesh, cfg,
                                           self.ssh_dense_inv, rhs)
            zvel, _ = soufflet.zonal_means(state, mesh, sst)
            u_rhs = soufflet.relax_zonal_vel(state, mesh, sst, cfg.dt, u_rhs,
                                             zvel)
            state = dynamics.update_vel(state, mesh, cfg, u_rhs, v_rhs, d_eta)
            state = ssh.compute_hbar(state, mesh, cfg, forcing)
            state = replace(state, eta=cfg.dyn.alpha * state.hbar
                            + (1.0 - cfg.dyn.alpha) * state.hbar_old)

        with record_function("step.ale"):
            state = ale.vert_vel_ale(state, mesh, cfg, forcing)
        with record_function("step.tracers"):
            state = solve_tracers(state, mesh, cfg, st, forcing, 0.0, sst)
        state = ale.update_thickness(state, mesh, cfg)
        return replace(state, step=state.step + 1)

    def step_fn(self):
        """The step with the public signature step(state, forcing) -> state."""
        return self.forward


# --------------------------------------------------------------------------
# tracer driver (ref solve_tracers_ale, oce_ale_tracer.F90:101-199)
# --------------------------------------------------------------------------
def solve_tracers(state: OceanState, mesh: MeshTables, cfg,
                  st: TracerStatics, forcing: Forcing, is_nonlinfs: float,
                  sst: Optional[soufflet.SouffletStatics] = None) -> OceanState:
    """All tracers advance together, stacked [T, nl-1, N]: MUSCL/QR4C
    advection with FCT, explicit horizontal diffusion, implicit vertical
    diffusion, soufflet relaxation and the salinity clamp."""
    dt = cfg.dt
    eps = cfg.dyn.epsilon
    nmask = mesh.node_layer_mask
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    ntr = cfg.tra.num_tracers
    tids = list(cfg.tra.tracer_ID[:ntr])
    t = state.tr[:ntr]

    # ---- stage 1: advection + explicit diffusion --------------------------
    # AB interpolation (init_tracers_AB, oce_tracer_mod.F90:48-62)
    tAB = -(0.5 + eps) * state.tr_old[:ntr] + (1.5 + eps) * t
    gxc, gyc = tracers.tracer_gradient_elements(torch.cat([tAB, t], 0), mesh)
    rec = tracers.fill_up_dn_grad_r(gxc[:ntr], gyc[:ntr], mesh, st)
    vflux = tracers._edge_vflux(state.u, state.v, state.helem, mesh)

    flux_v_lo = tracers.adv_ver_upw1(t, state.w_e, mesh)
    flux_h_lo, flux_h = tracers.adv_hor_lo_ho(t, tAB, vflux, mesh, st, rec,
                                              cfg.tra.tra_adv_ph)
    lo_h = edge_divergence(flux_h_lo, mesh)
    fct_lo = (t * state.hnode
              + (lo_h + (flux_v_lo[..., :-1, :] - flux_v_lo[..., 1:, :]))
              * dt / av) / torch.where(nmask, state.hnode_new, 1.0)
    fct_lo = torch.where(nmask, fct_lo, 0.0)
    flux_v = tracers.adv_ver_qr4c(tAB, state.w, state.Z_3d, state.zbar_3d,
                                  mesh, cfg.tra.tra_adv_pv,
                                  flux_prev=flux_v_lo)
    flux_h, flux_v = tracers.fct_limiter(t, fct_lo, flux_h, flux_v, mesh, dt)
    dttf_h, dttf_v = tracers.flux2dtracer(flux_h, flux_v, mesh, dt, ttf=t,
                                          lo=fct_lo, hnode=state.hnode,
                                          hnode_new=state.hnode_new)
    del_ttf = dttf_h + dttf_v + tracers.diff_hor(
        gxc[ntr:], gyc[ntr:], state.helem, st.Ki, mesh, dt)
    del_ttf = del_ttf + t * (state.hnode - state.hnode_new)
    t_expl = torch.where(
        nmask, t + del_ttf / torch.where(nmask, state.hnode_new, 1.0), 0.0)

    # ---- stage 2: surface sources + implicit vertical diffusion ----------
    surf_bc = torch.stack([
        tracers.bc_surface(tids[i], take_row(t_expl[i], mesh.ulevels_node - 1),
                           forcing, dt, is_nonlinfs)
        for i in range(ntr)])
    tr = tracers.diff_ver_impl(t_expl, state.Kv, state.hnode_new,
                               mesh.zbar_n_bot, mesh, dt, surf_bc)
    state = replace(state, tr=tr, tr_old=t)

    # relax to the zonal profile (ref :149-155)
    if sst is not None:
        _, ztem = soufflet.zonal_means(state, mesh, sst)
        state = replace(state, tr=soufflet.relax_zonal_temp(state, mesh, sst,
                                                            dt, ztem))

    # salinity clamp [3, 45] psu (ref :176-198)
    tr = state.tr.clone()
    tr[1] = torch.where(nmask, torch.clamp(state.tr[1], 3.0, 45.0), 0.0)
    return replace(state, tr=tr)


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------
def soufflet_config(step_per_day: int = 72) -> ModelConfig:
    """The soufflet channel configuration (ref namelist.config.toy_soufflet),
    as ``fesom2_tpu.model.setup_soufflet_model`` sets it."""
    cfg = ModelConfig()
    cfg.timestep.step_per_day = step_per_day
    cfg.run.toy_ocean = True
    cfg.run.which_toy = "soufflet"
    cfg.run.use_sw_pene = False
    cfg.geometry.cyclic_length = 4.5
    cfg.geometry.force_rotation = False
    cfg.ale.which_ALE = "linfs"
    cfg.dyn.state_equation = 0
    cfg.dyn.visc_option = 5
    cfg.dyn.gamma0 = 0.0
    cfg.dyn.gamma1 = 0.002
    cfg.dyn.gamma2 = 0.02
    cfg.dyn.easy_bs_return = 1.5
    cfg.dyn.A_ver = 1.0e-4
    cfg.dyn.mom_adv = 2
    cfg.dyn.scale_area = 5.8e9
    cfg.tra.K_ver = 1.0e-5
    cfg.tra.K_hor = 10.0
    cfg.tra.use_instabmix = True
    cfg.tra.instabmix_kv = 0.1
    cfg.tra.use_momix = False
    cfg.tra.tra_adv_hor = "MUSCL"
    cfg.tra.tra_adv_ver = "QR4C"
    cfg.tra.tra_adv_lim = "FCT"
    cfg.dyn.mix_scheme = "PP"
    return cfg


def setup_soufflet_model(mesh_path: Optional[str] = None, *,
                         device, dtype=torch.float64,
                         step_per_day: int = 72,
                         cfg: Optional[ModelConfig] = None) -> Model:
    """Build the soufflet channel model on ``device``.

    ``mesh_path``: a FESOM mesh directory; None builds the default channel
    in code (``mesh/channel.py``: 25 x 115 nodes, 40 layers of 100 m).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    cfg = cfg if cfg is not None else soufflet_config(step_per_day)
    check_slice(cfg)
    kw = dict(cyclic_length_deg=cfg.geometry.cyclic_length,
              force_rotation=False, dtype=dtype, device=device)
    if mesh_path is None:
        mesh = build_mesh_from_raw(channel_raw_mesh(), **kw)
    else:
        mesh = build_mesh(mesh_path, **kw)
    if mesh.n_nodes > DENSE_SSH_MAX_NODES:
        raise NotImplementedError("meshes above DENSE_SSH_MAX_NODES need the "
                                  "CG SSH solve: ROADMAP queue 1 item 6")
    tst = build_tracer_statics(mesh, K_hor=cfg.tra.K_hor, dtype=dtype)
    Z3 = mesh.Z[:, None].expand(mesh.nl - 1, mesh.n_nodes)
    dref = eos.reference_density(mesh, Z3, cfg.dyn.state_equation,
                                 toy_soufflet=True)
    _, _, sst = soufflet.setup_soufflet(mesh, dtype)
    dense_inv = ssh.ssh_dense_inverse(mesh, cfg, dtype)
    return Model(mesh, cfg, tst, dref, sst, dense_inv)
