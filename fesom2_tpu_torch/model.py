"""Top-level model: setup and the ocean step, on one device.

The port of the ocean step of ``fesom2_tpu/model.py``: the step mirrors
the reference orchestrator ``oce_timestep_ale`` (``src/oce_ale.F90:
2521-2799``) with the per-step pre-phase of ``fvom_main.F90:199-268``.
``Model`` is an ``nn.Module`` whose buffers are the static tables (mesh,
tracer statics, the soufflet statics where the channel runs, reference
density, and the SSH solver's: the dense inverse, or the ring operator and
block preconditioner of the CG solve above ``DENSE_SSH_MAX_NODES``
nodes); the step runs eagerly on the device those buffers live on.

Two configurations are set up here: the soufflet channel
(``setup_soufflet_model``) and the ocean of the benched CI configuration
on a global mesh (``pi_config``, ``setup_pi_model``: zstar with partial
cells, JM, KPP, GM/Redi, ``w_split``, MFCT/QR4C/FCT, shortwave
penetration).  Configuration branches outside the port raise
NotImplementedError naming the ROADMAP item that will port them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from .config import ModelConfig
from .constants import vcpw
from .mesh import MeshTables, build_mesh, build_mesh_from_raw
from .mesh.channel import channel_raw_mesh
from .core import eos, dynamics, ssh, ale, tracers, gm_redi
from .core.ops import edge_divergence, take_row
from .core.state import (OceanState, Forcing, allocate_state, initial_z3d,
                         init_thickness_linfs)
from .core.tracer_setup import TracerStatics, build_tracer_statics
from .core.mixing import kpp, pp as pp_mixing
from .toy import soufflet

# meshes up to this size solve SSH with a precomputed dense inverse
DENSE_SSH_MAX_NODES = 16384


def check_slice(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for every configuration branch the port
    does not have yet, naming its ROADMAP item."""
    missing = []
    if cfg.run.toy_ocean and cfg.run.which_toy != "soufflet":
        missing.append(f"the toy configuration '{cfg.run.which_toy}' "
                       "(queue 1 item 15)")
    if cfg.run.use_ice:
        missing.append("sea ice and the coupled step (items 11-13)")
    if cfg.run.use_cavity:
        missing.append("ice-shelf cavities (item 15)")
    if cfg.ale.which_ALE not in ("linfs", "zstar"):
        missing.append(f"which_ALE='{cfg.ale.which_ALE}' (item 8)")
    schemes = [s.strip().upper() for s in cfg.dyn.mix_scheme.split("+")]
    if schemes not in (["PP"], ["KPP"]):
        missing.append(f"mix_scheme='{cfg.dyn.mix_scheme}' (CVMix item 16)")
    if cfg.dyn.visc_option != 5:
        missing.append(f"visc_option={cfg.dyn.visc_option} (item 15)")
    if cfg.dyn.mom_adv != 2:
        missing.append(f"mom_adv={cfg.dyn.mom_adv} (item 15)")
    if not cfg.dyn.i_vert_visc or not cfg.tra.i_vert_diff:
        missing.append("explicit vertical viscosity/diffusion (item 15)")
    if cfg.dyn.SPP:
        missing.append("salt plume (item 15)")
    if cfg.diag.ldiag_DVD:
        missing.append("the DVD diagnostic (item 20)")
    if cfg.tra.num_tracers != 2 or list(cfg.tra.tracer_ID[:2]) != [0, 1]:
        missing.append("passive tracers (item 15)")
    if cfg.tra.clim_relax > 1e-8:
        missing.append("relaxation to climatology (item 19)")
    if cfg.tra.tra_adv_hor not in ("MUSCL", "MFCT") \
            or (cfg.tra.tra_adv_ver, cfg.tra.tra_adv_lim) != ("QR4C", "FCT"):
        missing.append("tracer schemes other than MUSCL or MFCT with "
                       "QR4C/FCT (item 15)")
    if missing:
        raise NotImplementedError("not ported yet (ROADMAP): "
                                  + "; ".join(missing))


class Model(nn.Module):
    """The static tables of one configuration, as buffers, and its step."""

    def __init__(self, mesh: MeshTables, cfg: ModelConfig,
                 tracer_statics: TracerStatics, density_ref: torch.Tensor,
                 soufflet_statics: Optional[soufflet.SouffletStatics] = None,
                 ssh_dense_inv: Optional[torch.Tensor] = None,
                 ssh_ring=None, ssh_block_pc=None):
        """The SSH solve is dense with ``ssh_dense_inv``, else CG with
        ``ssh_ring`` (``ssh.RingOperator`` under linfs, ``ssh.RingALE``
        under zstar) and ``ssh_block_pc`` (``ssh.BlockSchwarz``).
        ``soufflet_statics`` is given for the soufflet channel only."""
        super().__init__()
        check_slice(cfg)
        if (ssh_dense_inv is None) == (ssh_ring is None
                                       or ssh_block_pc is None):
            raise ValueError("give the dense SSH inverse, or the ring "
                             "operator and the block preconditioner")
        self.cfg = cfg
        self._static = {}
        self._cls = {}
        for prefix, obj in (("mesh", mesh), ("st", tracer_statics),
                            ("sst", soufflet_statics), ("ring", ssh_ring),
                            ("pc", ssh_block_pc)):
            if obj is not None:
                self._register(prefix, obj)
        self.register_buffer("density_ref", density_ref)
        self.register_buffer("ssh_dense_inv", ssh_dense_inv)
        # CG iterations of the last step's SSH solve (0 for the dense solve)
        self.ssh_iters = 0

    def _register(self, prefix: str, obj) -> None:
        """A dataclass's tensors as buffers ``<prefix>__<field>``, a nested
        dataclass (the mesh's cluster tables) under its own prefix."""
        statics = {}
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if isinstance(val, torch.Tensor):
                self.register_buffer(f"{prefix}__{f.name}", val)
            elif dataclasses.is_dataclass(val):
                self._register(f"{prefix}__{f.name}", val)
            else:
                statics[f.name] = val
        self._static[prefix] = statics
        self._cls[prefix] = type(obj)

    def _group(self, prefix: str):
        if prefix not in self._cls:
            return None
        kw = dict(self._static[prefix])
        for f in dataclasses.fields(self._cls[prefix]):
            name = f"{prefix}__{f.name}"
            if f.name not in kw:
                kw[f.name] = self._group(name) if name in self._cls \
                    else getattr(self, name)
        return self._cls[prefix](**kw)

    @property
    def mesh(self) -> MeshTables:
        return self._group("mesh")

    @property
    def tracer_statics(self) -> TracerStatics:
        return self._group("st")

    @property
    def soufflet_statics(self) -> Optional[soufflet.SouffletStatics]:
        return self._group("sst")

    @property
    def ssh_ring(self):
        """The CG operator's ring tables, or None (dense solve)."""
        return self._group("ring")

    @property
    def ssh_block_pc(self) -> Optional[ssh.BlockSchwarz]:
        return self._group("pc")

    @property
    def dtype(self):
        return self.density_ref.dtype

    # ------------------------------------------------------------------
    def initial_state(self) -> OceanState:
        """The unperturbed column at rest; the soufflet channel's initial
        temperature, salinity and velocity where it runs, else zero tracers
        for the caller to fill (``run.globe_ocean_inputs``)."""
        mesh = self.mesh
        state = allocate_state(mesh, self.cfg.tra.num_tracers, self.dtype,
                               with_gm=self.cfg.dyn.Fer_GM)
        state = init_thickness_linfs(state, mesh)
        if self.soufflet_statics is None:
            return state
        T, U, _ = soufflet.setup_soufflet(mesh, self.dtype)
        tr = state.tr.clone()
        tr[0] = T
        tr[1] = torch.where(mesh.node_layer_mask, 35.0, 0.0)
        return replace(state, tr=tr, tr_old=tr, u=U)

    # ------------------------------------------------------------------
    def forward(self, state: OceanState, forcing: Forcing,
                sw_3d: Optional[torch.Tensor] = None) -> OceanState:
        """One ocean step (ref oce_timestep_ale); ``sw_3d`` [nl, N] is the
        penetrating shortwave of ``tracers.shortwave_penetration`` or None.
        The named spans mark the step's layers for torch.profiler; they
        cost about a microsecond each when no profiler runs."""
        cfg = self.cfg
        sst = self.soufflet_statics
        mesh = self.mesh
        if sst is not None:
            mesh = replace(mesh, coriolis=sst.coriolis)
        st = self.tracer_statics

        with record_function("step.prephase"):
            state = dynamics.compute_vel_nodes(state, mesh)
            state = eos.pressure_bv(state, mesh, cfg, self.density_ref)
            state = dynamics.pressure_force(state, mesh, cfg)

        with record_function("step.mixing"):
            # ref oce_ale.F90:2596-2660: the main scheme, then mo_convect
            if cfg.dyn.mix_scheme.strip().upper() == "KPP":
                state = kpp.oce_mixing_kpp(state, mesh, cfg, forcing)
            else:
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
            if self.ssh_dense_inv is not None:
                d_eta, _ = ssh.solve_ssh_dense(state, mesh, cfg,
                                               self.ssh_dense_inv, rhs)
            else:
                d_eta, iters, _ = ssh.solve_ssh(
                    state, mesh, cfg, self.ssh_block_pc, rhs, self.ssh_ring,
                    x0=2.0 * state.d_eta - state.d_eta_prev)
                self.ssh_iters = int(iters)
                state = replace(state, d_eta=d_eta, d_eta_prev=state.d_eta)
            if sst is not None:
                zvel, _ = soufflet.zonal_means(state, mesh, sst)
                u_rhs = soufflet.relax_zonal_vel(state, mesh, sst, cfg.dt,
                                                 u_rhs, zvel)
            state = dynamics.update_vel(state, mesh, cfg, u_rhs, v_rhs, d_eta)
            state = ssh.compute_hbar(state, mesh, cfg, forcing)
            state = replace(state, eta=cfg.dyn.alpha * state.hbar
                            + (1.0 - cfg.dyn.alpha) * state.hbar_old)

        with record_function("step.gm_redi"):
            state, fer, redi = gm_redi_fields(state, mesh, cfg)
        with record_function("step.ale"):
            state = ale.vert_vel_ale(state, mesh, cfg, forcing)
        with record_function("step.tracers"):
            state = solve_tracers(state, mesh, cfg, st, forcing,
                                  0.0 if cfg.ale.which_ALE == "linfs" else 1.0,
                                  sst, fer=fer, redi=redi, sw_3d=sw_3d)
        state = ale.update_thickness(state, mesh, cfg)
        return replace(state, step=state.step + 1)

    def step_fn(self):
        """The step with the public signature
        step(state, forcing, sw_3d=None) -> state."""
        return self.forward


def gm_redi_fields(state: OceanState, mesh: MeshTables, cfg):
    """The GM bolus velocities and the Redi fields of this step (ref
    oce_ale.F90:2727-2739): returns (state, fer, redi) with fer = (fer_u,
    fer_v, fer_w) or None and redi = (tapered slope [3, nl-1, N], Ki
    [nl-1, N]) or None; the state carries the bolus fields where it has
    room for them (``allocate_state(with_gm=True)``)."""
    if not (cfg.dyn.Fer_GM or cfg.dyn.Redi):
        return state, None, None
    sig = gm_redi.compute_sigma_xy(state, mesh)
    ns, taper = gm_redi.compute_neutral_slope(sig, state.bvfreq, mesh)
    fer_c, fer_K, Ki_l = gm_redi.init_redi_gm(state, mesh, cfg, ns)
    fer = None
    if cfg.dyn.Fer_GM:
        gamma = gm_redi.fer_solve_gamma(state, mesh, sig, fer_c, fer_K)
        fer_u, fer_v = gm_redi.fer_gamma2vel(gamma, state, mesh)
        fer_w = ale.bolus_wvel(fer_u, fer_v, state, mesh)
        fer = (fer_u, fer_v, fer_w)
        if state.fer_u.shape[-1]:
            state = replace(state, fer_u=fer_u, fer_v=fer_v, fer_w=fer_w,
                            fer_K3=fer_K, fer_c=fer_c)
    return state, fer, ((taper, Ki_l) if cfg.dyn.Redi else None)


# --------------------------------------------------------------------------
# tracer driver (ref solve_tracers_ale, oce_ale_tracer.F90:101-199)
# --------------------------------------------------------------------------
def solve_tracers(state: OceanState, mesh: MeshTables, cfg,
                  st: TracerStatics, forcing: Forcing, is_nonlinfs: float,
                  sst: Optional[soufflet.SouffletStatics] = None, fer=None,
                  redi=None, sw_3d=None) -> OceanState:
    """All tracers advance together, stacked [T, nl-1, N]: MUSCL or MFCT
    and QR4C advection with FCT (the low-order solution implicit in the w
    split's w_i), horizontal diffusion with the Redi terms, implicit
    vertical diffusion with the Redi K33, the shortwave and KPP nonlocal
    sources, soufflet relaxation and the salinity clamp.  ``fer`` are the
    GM bolus velocities, which advect tracers only (ref :126-136)."""
    dt = cfg.dt
    eps = cfg.dyn.epsilon
    nmask = mesh.node_layer_mask
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    ntr = cfg.tra.num_tracers
    tids = list(cfg.tra.tracer_ID[:ntr])
    t = state.tr[:ntr]
    adv_u, adv_v, adv_we, adv_w = state.u, state.v, state.w_e, state.w
    if fer is not None:
        adv_u, adv_v = adv_u + fer[0], adv_v + fer[1]
        adv_we, adv_w = adv_we + fer[2], adv_w + fer[2]

    # ---- stage 1: advection + explicit diffusion --------------------------
    # AB interpolation (init_tracers_AB, oce_tracer_mod.F90:48-62)
    tAB = -(0.5 + eps) * state.tr_old[:ntr] + (1.5 + eps) * t
    gxc, gyc = tracers.tracer_gradient_elements(torch.cat([tAB, t], 0), mesh)
    gx, gy = gxc[ntr:], gyc[ntr:]
    rec = tracers.fill_up_dn_grad_r(gxc[:ntr], gyc[:ntr], mesh, st)
    vflux = tracers._edge_vflux(adv_u, adv_v, state.helem, mesh)

    flux_v_lo = tracers.adv_ver_upw1(t, adv_we, mesh)
    flux_h_lo, flux_h = tracers.adv_hor_lo_ho(t, tAB, vflux, mesh, st, rec,
                                              cfg.tra.tra_adv_ph,
                                              scheme=cfg.tra.tra_adv_hor)
    lo_h = edge_divergence(flux_h_lo, mesh)
    fct_lo = (t * state.hnode
              + (lo_h + (flux_v_lo[..., :-1, :] - flux_v_lo[..., 1:, :]))
              * dt / av) / torch.where(nmask, state.hnode_new, 1.0)
    fct_lo = torch.where(nmask, fct_lo, 0.0)
    if cfg.dyn.w_split:
        # the low-order solution takes the implicit part too; the
        # high-order flux is then taken against the full-w upwind flux
        fct_lo = tracers.adv_vert_impl(fct_lo, state.w_i, state.hnode_new,
                                       mesh, dt)
        flux_v_lo = tracers.adv_ver_upw1(t, adv_w, mesh)
    flux_v = tracers.adv_ver_qr4c(tAB, adv_w, state.Z_3d, state.zbar_3d,
                                  mesh, cfg.tra.tra_adv_pv,
                                  flux_prev=flux_v_lo)
    flux_h, flux_v = tracers.fct_limiter(t, fct_lo, flux_h, flux_v, mesh, dt)
    dttf_h, dttf_v = tracers.flux2dtracer(flux_h, flux_v, mesh, dt, ttf=t,
                                          lo=fct_lo, hnode=state.hnode,
                                          hnode_new=state.hnode_new)
    del_ttf = dttf_h + dttf_v
    if redi is not None:
        taper, Ki_l = redi
        tr_z = tracers.tracer_gradient_z(t, state.Z_3d, mesh)
        del_ttf = del_ttf + tracers.diff_hor(gx, gy, state.helem, Ki_l, mesh,
                                             dt, tr_z=tr_z,
                                             slope_tapered=taper)
        del_ttf = del_ttf + tracers.diff_ver_redi_expl(
            gx, gy, taper, Ki_l, state.hnode_new, mesh, dt)
    else:
        del_ttf = del_ttf + tracers.diff_hor(gx, gy, state.helem, st.Ki,
                                             mesh, dt)
    del_ttf = del_ttf + t * (state.hnode - state.hnode_new)
    t_expl = torch.where(
        nmask, t + del_ttf / torch.where(nmask, state.hnode_new, 1.0), 0.0)

    # ---- stage 2: surface sources + implicit vertical diffusion ----------
    surf_bc = torch.stack([
        tracers.bc_surface(tids[i], take_row(t_expl[i], mesh.ulevels_node - 1),
                           forcing, dt, is_nonlinfs)
        for i in range(ntr)])
    src = _tracer_sources(t_expl, state, mesh, cfg, forcing, tids, av, sw_3d)
    kw = dict(sw_source=src)
    if redi is not None:
        kw.update(Ki_layered=redi[1], slope3=redi[0][2])
    if cfg.tra.double_diffusion and cfg.dyn.mix_scheme.upper() == "KPP":
        # salinity diffuses with the double-diffusive Kv_s
        tr = torch.cat([tracers.diff_ver_impl(
            t_expl[i:i + 1], state.Kv_s if tids[i] == 1 else state.Kv,
            state.hnode_new, mesh.zbar_n_bot, mesh, dt, surf_bc[i:i + 1],
            **dict(kw, sw_source=None if src is None else src[i:i + 1]))
            for i in range(ntr)])
    else:
        tr = tracers.diff_ver_impl(t_expl, state.Kv, state.hnode_new,
                                   mesh.zbar_n_bot, mesh, dt, surf_bc, **kw)
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


def _tracer_sources(t_expl, state: OceanState, mesh: MeshTables, cfg,
                    forcing: Forcing, tids, av, sw_3d):
    """Interior sources [T, nl-1, N] of stage 2, or None: the shortwave
    heating of temperature and the KPP nonlocal redistribution of the
    surface heat and water fluxes (ref oce_ale_tracer.F90:688-790)."""
    use_kpp_nl = cfg.dyn.use_kpp_nonlclflx \
        and cfg.dyn.mix_scheme.upper() == "KPP"
    if sw_3d is None and not use_kpp_nl:
        return None
    nmask = mesh.node_layer_mask
    srcs = []
    for i, tid in enumerate(tids):
        src = torch.zeros_like(t_expl[i])
        if sw_3d is not None and tid == 0:
            src = src + tracers.sw_3d_source(sw_3d, mesh, cfg.dt)
        if use_kpp_nl and tid in (0, 1):
            G = state.kpp_nonloc
            gdiv = G[:-1] * (mesh.area[:-1] / av) - G[1:] * (mesh.area[1:] / av)
            if tid == 0:
                nl_src = gdiv * (forcing.heat_flux / vcpw * cfg.dt)[None, :]
            else:
                rsss = t_expl[i][0] if cfg.tra.ref_sss_local \
                    else cfg.tra.ref_sss
                nl_src = -gdiv * (rsss * forcing.water_flux * cfg.dt)
            src = src + torch.where(nmask, nl_src, 0.0)
        srcs.append(src)
    return torch.stack(srcs)


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------
def soufflet_config(step_per_day: int = 72,
                    which_ale: str = "linfs") -> ModelConfig:
    """The soufflet channel configuration (ref namelist.config.toy_soufflet),
    as ``fesom2_tpu.model.setup_soufflet_model`` sets it."""
    cfg = ModelConfig()
    cfg.timestep.step_per_day = step_per_day
    cfg.run.toy_ocean = True
    cfg.run.which_toy = "soufflet"
    cfg.run.use_sw_pene = False
    cfg.geometry.cyclic_length = 4.5
    cfg.geometry.force_rotation = False
    cfg.ale.which_ALE = which_ale
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


def _ssh_solver(mesh: MeshTables, cfg, dtype) -> dict:
    """The SSH solver's tables as Model keywords: the dense inverse up to
    ``DENSE_SSH_MAX_NODES`` nodes, else the block preconditioner and the
    ring (linfs) or ALE ring (zstar) operator of the CG solve
    (``fesom2_tpu/model.py:873-882``)."""
    if mesh.n_nodes <= DENSE_SSH_MAX_NODES:
        return dict(ssh_dense_inv=ssh.ssh_dense_inverse(mesh, cfg, dtype))
    ring = ssh.build_ssh_ring(mesh, cfg, dtype) \
        if cfg.ale.which_ALE == "linfs" \
        else ssh.build_ssh_ring_ale(mesh, cfg, dtype)
    return dict(ssh_ring=ring,
                ssh_block_pc=ssh.build_block_schwarz(mesh, cfg, dtype=dtype))


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return device


def setup_soufflet_model(mesh_path: Optional[str] = None, *,
                         device, dtype=torch.float64,
                         step_per_day: int = 72, which_ale: str = "linfs",
                         cfg: Optional[ModelConfig] = None) -> Model:
    """Build the soufflet channel model on ``device``.

    ``mesh_path``: a FESOM mesh directory; None builds the default channel
    in code (``mesh/channel.py``: 25 x 115 nodes, 40 layers of 100 m).
    ``which_ale``: "linfs" or "zstar" (ignored when ``cfg`` is given).
    Meshes up to ``DENSE_SSH_MAX_NODES`` nodes get the dense SSH inverse,
    larger ones the CG tables (``_ssh_solver``).
    """
    device = _check_device(device)
    cfg = cfg if cfg is not None else soufflet_config(step_per_day, which_ale)
    check_slice(cfg)
    kw = dict(cyclic_length_deg=cfg.geometry.cyclic_length,
              force_rotation=False, dtype=dtype, device=device)
    if mesh_path is None:
        mesh = build_mesh_from_raw(channel_raw_mesh(), **kw)
    else:
        mesh = build_mesh(mesh_path, **kw)
    tst = build_tracer_statics(mesh, K_hor=cfg.tra.K_hor, dtype=dtype)
    Z3 = mesh.Z[:, None].expand(mesh.nl - 1, mesh.n_nodes)
    dref = eos.reference_density(mesh, Z3, cfg.dyn.state_equation,
                                 toy_soufflet=True)
    _, _, sst = soufflet.setup_soufflet(mesh, dtype)
    return Model(mesh, cfg, tst, dref, sst, **_ssh_solver(mesh, cfg, dtype))


def pi_config(parity: str = "ci", step_per_day: int = 96) -> ModelConfig:
    """The configuration ``fesom2_tpu.model.setup_pi_model`` builds
    (``fesom2_tpu/model.py:793-836``) with ``parity="ci"``, field for
    field: the reference CI configuration (zstar, partial cells with
    threshold 0, JM, KPP, ``visc_option=5``, ``w_split`` with
    ``w_max_cfl=1``, MFCT/QR4C/FCT, Fer_GM + Redi with the CI values,
    ``K_hor=3000``, shortwave penetration, ``force_rotation``).  No other
    parity is ported: any other value raises.

    It keeps ``run.use_ice = True``, as the JAX configuration does.  The
    port runs the ocean step alone (the ice and the coupled step are ROADMAP
    queue 1 items 11-13), so the caller sets ``cfg.run.use_ice = False``
    before ``setup_pi_model``; with ice on, ``check_slice`` raises.
    """
    if parity != "ci":
        raise ValueError(f"parity must be 'ci', not {parity!r}")
    cfg = ModelConfig()
    cfg.timestep.step_per_day = step_per_day
    cfg.run.use_ice = True
    cfg.run.use_sw_pene = True
    cfg.geometry.force_rotation = True
    cfg.dyn.state_equation = 1
    cfg.dyn.visc_option = 5
    cfg.dyn.w_split = True
    cfg.dyn.w_max_cfl = 1.0
    cfg.ice.whichEVP = 1
    cfg.ice.evp_rheol_steps = 120
    cfg.ice.evp_subdomain_lat = 40.0
    cfg.tra.tra_adv_hor = "MFCT"
    cfg.tra.tra_adv_ver = "QR4C"
    cfg.tra.tra_adv_lim = "FCT"
    cfg.ale.which_ALE = "zstar"          # namelist.config:32
    cfg.ale.use_partial_cell = True      # namelist.config:33
    cfg.ale.partial_cell_thresh = 0.0
    cfg.dyn.mix_scheme = "KPP"           # namelist.oce:42
    cfg.dyn.gamma0 = 0.003               # namelist.oce:5-7
    cfg.dyn.gamma1 = 0.1
    cfg.dyn.gamma2 = 0.285
    cfg.dyn.easy_bs_return = 1.5         # namelist.oce:18
    cfg.dyn.Div_c = 0.5                  # setup.yml overrides
    cfg.dyn.Leith_c = 0.05
    cfg.dyn.Fer_GM = True                # namelist.oce:27-40
    cfg.dyn.Redi = True
    cfg.dyn.K_GM_max = 2000.0
    cfg.dyn.K_GM_min = 2.0
    cfg.dyn.K_GM_bvref = 2
    cfg.dyn.K_GM_rampmax = -1.0
    cfg.dyn.K_GM_rampmin = -1.0
    cfg.dyn.scaling_Ferreira = False
    cfg.dyn.scaling_Rossby = False
    cfg.dyn.scaling_resolution = True
    cfg.tra.K_ver = 1.0e-5               # namelist.oce:65-72
    cfg.tra.K_hor = 3000.0
    cfg.tra.surf_relax_T = 0.0
    cfg.tra.surf_relax_S = 1.929e-06
    cfg.tra.clim_relax = 0.0
    cfg.tra.ref_sss_local = True
    cfg.tra.ref_sss = 34.0
    return cfg


def setup_pi_model(mesh_path: str, *, device, dtype=torch.float64,
                   cfg: Optional[ModelConfig] = None) -> Model:
    """The ocean of the global configuration on ``device``, as
    ``fesom2_tpu/model.py:_finish_pi_setup`` (:849-886) builds it:

    1. the mesh tables with ``force_rotation``, a cyclic length of 360
       degrees and the configuration's partial cells;
    2. the tracer statics;
    3. the unperturbed ``initial_z3d`` and the reference density on its
       mid depths (partial cells move the bottom layer's);
    4. the dense SSH inverse, or the block preconditioner and the ALE
       ring (linfs: ring) of the CG solve above ``DENSE_SSH_MAX_NODES``.

    ``cfg`` defaults to ``pi_config()`` with the ice off.  Neither the
    forcing files nor the ice subdomain are read or built: the port runs
    the ocean step alone, driven by ``run.run_pi_ocean``.
    """
    device = _check_device(device)
    if cfg is None:
        cfg = pi_config()
        cfg.run.use_ice = False
    check_slice(cfg)
    mesh = build_mesh(mesh_path, force_rotation=True, cyclic_length_deg=360.0,
                      use_partial_cell=cfg.ale.use_partial_cell,
                      partial_cell_thresh=cfg.ale.partial_cell_thresh,
                      dtype=dtype, device=device)
    tst = build_tracer_statics(mesh, K_hor=cfg.tra.K_hor, dtype=dtype)
    _, Z3 = initial_z3d(mesh, dtype)
    dref = eos.reference_density(mesh, Z3, cfg.dyn.state_equation)
    return Model(mesh, cfg, tst, dref, **_ssh_solver(mesh, cfg, dtype))
