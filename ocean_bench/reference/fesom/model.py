# Frozen copy of fesom2_tpu_torch/model.py, lines 1-1255 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Top-level model: setup, the ocean step and the coupled ocean + ice
step, on one device.

The port of ``fesom2_tpu/model.py``: the ocean step mirrors the reference
orchestrator ``oce_timestep_ale`` (``src/oce_ale.F90:2521-2799``), the
coupled step the hot loop of ``fvom_main.F90:199-268`` (forcing update ->
ocean2ice -> ice step -> fluxes to the ocean -> ocean step).  ``Model`` is
an ``nn.Module`` whose buffers are the static tables (mesh, tracer
statics, the soufflet statics where the channel runs, reference density,
the ice subdomain, and the SSH solver's: the dense inverse, or the ring
operator and block preconditioner of the CG solve above
``DENSE_SSH_MAX_NODES`` nodes); the step runs eagerly on the device those
buffers live on.

Two configurations are set up here: the soufflet channel
(``setup_soufflet_model``, linfs, zlevel or zstar) and the benched
configurations on a global mesh (``pi_config``, ``setup_pi_model``,
``pi_initial_state``, ``pi_coupled_step_fn``): the CI one (zstar with
partial cells, JM, KPP, GM/Redi, ``w_split``, MFCT/QR4C/FCT, shortwave
penetration, mEVP sea ice on the polar-cap subdomain, FCT ice advection,
ice thermodynamics, NCAR bulk forcing) and the fast one (the same on
linfs with PP, full cells and no GM/Redi), each with ice-shelf cavities
where a draft is given (``setup_pi_model(cavity_depth=...)``) and on a
refined mesh (``n_refine``).  The column-physics menus of the JAX step
run on any of them: every ``mix_scheme`` (PP, KPP and the CVMix schemes,
``vertical_mixing``), every tracer advection scheme with or without the
FCT limiter, explicit vertical viscosity and diffusion, passive tracers
(``setup_passive_tracers``) and the salt plume.  A toy channel of
another name than soufflet runs without the soufflet physics, as in the
JAX package.  The ice runs any of the three EVP rheologies (``whichEVP``
0, 1, 2), or, with ``cfg.run.use_icepack``, the multi-category Icepack
column physics (``ice/icepack``; its mEVP on the whole mesh); the forcing
and the initial state come from files where a ``forcing_path`` is given
(the NCEP test set or the ``&nam_sbc`` layout, and the WOA18
climatology), else they are built in code; the tidal
potential, the sea-level pressure term and the relaxation to climatology
run where the configuration asks for them; with ``cfg.diag.ldiag_DVD``
the tracer step also computes the discrete variance decay (``dvd_h``,
``dvd_v``).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import replace
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from .config import ModelConfig
from .constants import rad, vcpw
from .mesh import MeshTables, build_mesh, build_mesh_from_raw
from .mesh.channel import channel_raw_mesh
from .mesh.refine import refined_mesh
from .parallel.padding import pad_mesh
from .core import eos, dynamics, ssh, ale, tracers, gm_redi, cavity
from .core.ops import edge_divergence, take_row
from .core.state import (OceanState, Forcing, allocate_state, initial_z3d,
                         init_thickness_linfs, zero_forcing)
from .forcing import tides
from .forcing.atmos import (AtmData, load_sbc_forcing, ncep_test_sbc,
                            update_atm_forcing)
from .core.ic import climatology_ic
from .utils.support import host
from .ice import coupling as ice_cpl
from .ice.state import IceState, IceForcing, allocate_ice, zero_ice_forcing
from .ice.step import ice_timestep
from .ice.subdomain import IceSubdomain, build_ice_subdomain
from .mesh.globe import globe_atm_fixtures, globe_fixtures
from .core.tracer_setup import TracerStatics, build_tracer_statics
from .core.mixing import cvmix, kpp, pp as pp_mixing
from .toy import soufflet

# meshes up to this size solve SSH with a precomputed dense inverse
DENSE_SSH_MAX_NODES = 16384


MAIN_MIX_SCHEMES = ("KPP", "PP", "CVMIX_PP", "CVMIX_KPP", "CVMIX_TKE")
MIX_ADDONS = ("CVMIX_IDEMIX", "CVMIX_TIDAL", "CVMIX_DDIFF", "CVMIX_CONV")


def mix_schemes(cfg: ModelConfig):
    """(main scheme or None, every component) of ``cfg.dyn.mix_scheme``,
    its components joined by '+', upper case (``fesom2_tpu/model.py:139-145``)."""
    schemes = [s.strip().upper() for s in cfg.dyn.mix_scheme.split("+")]
    main = [s for s in schemes if s not in MIX_ADDONS]
    return (main[0] if main else None), schemes


def check_slice(cfg: ModelConfig) -> None:
    """Raise ValueError for a name the JAX package does not know either
    (every configuration branch of the JAX package is ported)."""
    if cfg.ale.which_ALE not in ("linfs", "zlevel", "zstar"):
        raise ValueError(f"which_ALE='{cfg.ale.which_ALE}': linfs, zlevel "
                         "or zstar")
    main, _ = mix_schemes(cfg)
    if main is not None and main not in MAIN_MIX_SCHEMES:
        raise ValueError(f"unknown mix_scheme {cfg.dyn.mix_scheme}")


class Model(nn.Module):
    """The static tables of one configuration, as buffers, and its step."""

    def __init__(self, mesh: MeshTables, cfg: ModelConfig,
                 tracer_statics: TracerStatics, density_ref: torch.Tensor,
                 soufflet_statics: Optional[soufflet.SouffletStatics] = None,
                 ssh_dense_inv: Optional[torch.Tensor] = None,
                 ssh_ring=None, ssh_block_pc=None,
                 ice_sub: Optional[IceSubdomain] = None,
                 ssh_diag_inv: Optional[torch.Tensor] = None):
        """The SSH solve is dense with ``ssh_dense_inv``, else CG with
        ``ssh_ring`` (``ssh.RingOperator`` under linfs, ``ssh.RingALE``
        under zlevel and zstar; without one the matrix-free
        ``ssh.ssh_operator``) preconditioned by ``ssh_block_pc``
        (``ssh.BlockSchwarz``) or, without one, the Jacobi diagonal
        ``ssh_diag_inv`` [N] (the distributed formulation,
        ``parallel/dist.py``).  ``soufflet_statics`` is given for the
        soufflet channel only; ``ice_sub`` restricts the EVP subcycles to
        the polar caps."""
        super().__init__()
        check_slice(cfg)
        self.cfg = cfg
        self._static = {}
        self._cls = {}
        for prefix, obj in (("mesh", mesh), ("st", tracer_statics),
                            ("sst", soufflet_statics), ("sub", ice_sub)):
            if obj is not None:
                self._register(prefix, obj)
        self.register_buffer("density_ref", density_ref)
        self.set_ssh_solver(ssh_dense_inv, ssh_ring, ssh_block_pc,
                            ssh_diag_inv)
        # the region-restored passive tracers: their indices in the tracer
        # stack and node masks [P, N] (``setup_passive_tracers``)
        self.ptr_idx, masks = passive_tracer_masks(mesh, cfg)
        self.register_buffer("ptr_masks", masks)
        # the surface salinity the SSS relaxation restores to, [N]
        # (``pi_initial_state`` sets it)
        self.register_buffer("Ssurf", None)
        # the climatology of relax_to_clim, T and S [nl-1, N], and its
        # nodal relaxation rate [N] in 1/s (ref Tclim, Sclim, relax2clim,
        # oce_modules.F90:249,255; ``pi_initial_state`` sets them, the rate
        # to 0: a caller sets the sponge); the relaxation runs where
        # ``cfg.tra.clim_relax`` > 1e-8
        self.register_buffer("Tclim", None)
        self.register_buffer("Sclim", None)
        self.register_buffer("relax2clim", None)
        # the forcing source of ``setup_pi_model(forcing_path=...)``
        # (an SbcConfig), for ``run.run_pi``'s year switch; None otherwise
        self.sbc = None
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

    def _unregister(self, prefix: str) -> None:
        """Drop the buffers of a group registered under ``prefix``."""
        for name in [n for n in self._buffers if n.startswith(prefix + "__")]:
            delattr(self, name)
        for key in [k for k in self._cls if k == prefix
                    or k.startswith(prefix + "__")]:
            del self._cls[key]
            self._static.pop(key, None)

    def set_ssh_solver(self, dense_inv=None, ring=None, block_pc=None,
                       diag_inv=None) -> None:
        """Replace the SSH solver's tables (the keywords of ``__init__``):
        the dense inverse, or CG with a preconditioner, the block one or
        the Jacobi diagonal, on the ring operator or matrix-free."""
        if dense_inv is None and block_pc is None and diag_inv is None:
            raise ValueError("give the dense SSH inverse, or a "
                             "preconditioner of the CG solve (the block "
                             "preconditioner or the Jacobi diagonal)")
        # the block preconditioner with the kernel's packed layout of its
        # inverses (made here, once, where it lacks one)
        packed = None if block_pc is None else (
            block_pc.packed if block_pc.packed is not None
            else ssh.pack_block_schwarz(block_pc))
        for prefix, obj in (("ring", ring), ("pc", block_pc),
                            ("pcp", packed)):
            self._unregister(prefix)
            if obj is not None:
                self._register(prefix, obj)
        self.register_buffer("ssh_dense_inv", dense_inv)
        self.register_buffer("ssh_diag_inv", diag_inv)

    def set_ice_sub(self, sub: Optional[IceSubdomain]) -> None:
        """Replace the EVP subdomain (None: the whole mesh)."""
        self._unregister("sub")
        if sub is not None:
            self._register("sub", sub)

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
        pc = self._group("pc")
        if pc is not None:
            pc.packed = self._group("pcp")
        return pc

    @property
    def ice_sub(self) -> Optional[IceSubdomain]:
        """The polar-cap tables of the EVP subcycles, or None (whole mesh)."""
        return self._group("sub")

    @property
    def dtype(self):
        return self.density_ref.dtype

    @property
    def is_soufflet(self) -> bool:
        """The soufflet channel's own physics runs (its zonal relaxation and
        beta-plane Coriolis): a toy channel of another name runs without."""
        run = self.cfg.run
        return run.toy_ocean and run.which_toy == "soufflet"

    def climatology(self):
        """(Tclim, Sclim, relax2clim) of relax_to_clim, or None: where all
        three are set and ``cfg.tra.clim_relax`` > 1e-8
        (``fesom2_tpu/model.py:115-116``)."""
        if (self.Tclim is None or self.relax2clim is None
                or self.cfg.tra.clim_relax <= 1e-8):
            return None
        return self.Tclim, self.Sclim, self.relax2clim

    def ptracer_masks(self):
        """[(tracer index, node mask [N])] of the region-restored tracers,
        or None."""
        if not self.ptr_idx:
            return None
        return list(zip(self.ptr_idx, self.ptr_masks))

    # ------------------------------------------------------------------
    def initial_state(self) -> OceanState:
        """The unperturbed column at rest; the soufflet channel's initial
        temperature, salinity and velocity where it runs, else zero T/S
        for the caller to fill (``run.globe_ocean_inputs``); the passive
        tracers of ``setup_passive_tracers`` (``fesom2_tpu/model.py:62-74``);
        room for T's and S's DVD under ``ldiag_DVD``."""
        mesh = self.mesh
        state = allocate_state(mesh, self.cfg.tra.num_tracers, self.dtype,
                               n_dvd=2 if self.cfg.diag.ldiag_DVD else 0,
                               with_gm=self.cfg.dyn.Fer_GM)
        state = init_thickness_linfs(state, mesh)
        if self.is_soufflet:
            T, U, _ = soufflet.setup_soufflet(mesh, self.dtype)
            tr = state.tr.clone()
            tr[0] = T
            tr[1] = torch.where(mesh.node_layer_mask, 35.0, 0.0)
            state = replace(state, tr=tr, tr_old=tr, u=U)
        if self.cfg.tra.num_tracers > 2:
            state = setup_passive_tracers(self, state)
        return state

    # ------------------------------------------------------------------
    def forward(self, state: OceanState, forcing: Forcing,
                sw_3d: Optional[torch.Tensor] = None) -> OceanState:
        """One ocean step (ref oce_timestep_ale); ``sw_3d`` [nl, N] is the
        penetrating shortwave of ``tracers.shortwave_penetration`` or None.
        The named spans mark the step's layers for torch.profiler; they
        cost about a microsecond each when no profiler runs."""
        cfg = self.cfg
        sst = self.soufflet_statics if self.is_soufflet else None
        mesh = self.mesh
        if sst is not None:
            mesh = replace_coriolis(mesh, sst.coriolis)
        st = self.tracer_statics

        with record_function("step.prephase"):
            state = dynamics.compute_vel_nodes(state, mesh)
            state = eos.pressure_bv(state, mesh, cfg, self.density_ref)
            state = dynamics.pressure_force(state, mesh, cfg)

        state = vertical_mixing(state, mesh, cfg, forcing, sw_3d)

        with record_function("step.momentum"):
            rhs_fn = dynamics.compute_vel_rhs_vinv if cfg.dyn.mom_adv == 3 \
                else dynamics.compute_vel_rhs
            state, u_rhs, v_rhs = rhs_fn(state, mesh, forcing, cfg)
            state, u_rhs, v_rhs = dynamics.viscosity_filter(state, mesh, cfg,
                                                            u_rhs, v_rhs)
            if cfg.dyn.i_vert_visc:
                u_rhs, v_rhs = dynamics.impl_vert_visc(state, mesh, cfg,
                                                       forcing, u_rhs, v_rhs)

        with record_function("step.ssh"):
            rhs = ssh.compute_ssh_rhs(state, mesh, cfg, forcing, u_rhs, v_rhs)
            if self.ssh_dense_inv is not None:
                d_eta, _ = ssh.solve_ssh_dense(state, mesh, cfg,
                                               self.ssh_dense_inv, rhs)
            else:
                pc = self.ssh_block_pc
                if pc is None:
                    dinv = self.ssh_diag_inv
                    pc = lambda r: dinv * r
                d_eta, iters, _ = ssh.solve_ssh(
                    state, mesh, cfg, pc, rhs, self.ssh_ring,
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
                                  sst, fer=fer, redi=redi, sw_3d=sw_3d,
                                  clim=self.climatology(),
                                  ptr_masks=self.ptracer_masks())
        state = ale.update_thickness(state, mesh, cfg)
        return replace(state, step=state.step + 1)

    def step_fn(self):
        """The step with the public signature
        step(state, forcing, sw_3d=None) -> state."""
        return self.forward


def replace_coriolis(mesh: MeshTables, coriolis_elem) -> MeshTables:
    """``mesh`` with the element Coriolis parameter ``coriolis_elem`` [E]
    (the channel's beta plane; ``fesom2_tpu/model.py:313-315``)."""
    return replace(mesh, coriolis=coriolis_elem)


def vertical_mixing(state: OceanState, mesh: MeshTables, cfg,
                    forcing: Forcing, sw_3d=None, iw_surf=None, iw_bot=None,
                    tidal_forc=None) -> OceanState:
    """Kv, Av (and what the schemes carry: tke, iwe, the KPP nonlocal
    flux) of ``cfg.dyn.mix_scheme`` (ref oce_ale.F90:2596-2660, as
    ``fesom2_tpu/model.py:136-183``): IDEMIX first, then the main scheme,
    then ``mo_convect`` where there is a main scheme, then tidal mixing,
    then the double-diffusion and convection add-ons.  The IDEMIX and TKE
    steps run under spans of their own (``step.mixing.idemix``,
    ``step.mixing.tke``), the rest under ``step.mixing``.  ``iw_surf``,
    ``iw_bot`` and ``tidal_forc`` default to zeros, as the JAX package
    never sets them."""
    main, schemes = mix_schemes(cfg)
    if "CVMIX_IDEMIX" in schemes:
        with record_function("step.mixing.idemix"):
            state = cvmix.calc_cvmix_idemix(state, mesh, cfg, forcing,
                                            iw_surf=iw_surf, iw_bot=iw_bot,
                                            standalone=main is None)
    if main == "CVMIX_TKE":
        with record_function("step.mixing.tke"):
            if "CVMIX_IDEMIX" in schemes:
                state = cvmix.calc_cvmix_tke(
                    state, mesh, cfg, forcing, iw_diss=state.iwe_diss,
                    iwe=state.iwe, iwe_alpha_c=state.iwe_alpha_c)
            else:
                state = cvmix.calc_cvmix_tke(state, mesh, cfg, forcing)
    with record_function("step.mixing"):
        if main == "KPP":
            state = kpp.oce_mixing_kpp(state, mesh, cfg, forcing)
        elif main == "PP":
            state = pp_mixing.oce_mixing_pp(state, mesh, cfg)
        elif main == "CVMIX_PP":
            state = cvmix.calc_cvmix_pp(state, mesh, cfg)
        elif main == "CVMIX_KPP":
            state = cvmix.calc_cvmix_kpp(state, mesh, cfg, forcing,
                                         sw_3d=sw_3d)
        if main is not None:
            state = pp_mixing.mo_convect(state, mesh, cfg, forcing)
        if "CVMIX_TIDAL" in schemes:
            state = cvmix.calc_cvmix_tidal(state, mesh, cfg,
                                           tidal_forc=tidal_forc)
        if "CVMIX_DDIFF" in schemes:
            state = cvmix.calc_cvmix_ddiff(state, mesh, cfg)
        if "CVMIX_CONV" in schemes:
            state = cvmix.calc_cvmix_convection(state, mesh, cfg)
    return state


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
# passive tracers (ref oce_setup_step.F90:486-592)
# --------------------------------------------------------------------------
# the source regions of the 3D-restored passive tracers:
# (lat0, lat1, lon0, lon1) in degrees
PTRACER_REGIONS = {301: (77.5, 78.0, 0.0, 10.0),       # Fram Strait
                   302: (65.6, 66.0, -172.0, -166.0),  # Bering Strait
                   303: (69.5, 74.5, 19.0, 20.0)}      # Barents Sea Opening


def passive_tracer_masks(mesh: MeshTables, cfg):
    """(indices, masks [P, N] or None) of the tracers beyond T/S whose id
    has a region in ``PTRACER_REGIONS`` (``fesom2_tpu/model.py:453-477``).
    A region may hold no node of a coarse mesh."""
    glon = mesh.geo_coords[:, 0] / rad
    glat = mesh.geo_coords[:, 1] / rad
    idx, masks = [], []
    for i, tid in enumerate(cfg.tra.tracer_ID[:cfg.tra.num_tracers]):
        if i >= 2 and tid in PTRACER_REGIONS:
            la0, la1, lo0, lo1 = PTRACER_REGIONS[tid]
            idx.append(i)
            masks.append((glat > la0) & (glat < la1) & (glon > lo0)
                         & (glon < lo1))
    return idx, (torch.stack(masks) if masks else None)


def setup_passive_tracers(model: "Model", state: OceanState) -> OceanState:
    """The tracers beyond T/S by id (ref oce_setup_step.F90:486-592): 101,
    the rain-water tracer, and any id without a region start at 0; 301,
    302 and 303, the strait-release tracers, start at 1 in their region
    (``model.ptr_masks``) and 0 elsewhere."""
    tr = state.tr.clone()
    tr[2:] = 0.0
    for i, pmask in model.ptracer_masks() or ():
        tr[i] = torch.where(pmask[None, :] & model.mesh.node_layer_mask,
                            1.0, 0.0)
    return replace(state, tr=tr, tr_old=tr)


# --------------------------------------------------------------------------
# tracer driver (ref solve_tracers_ale, oce_ale_tracer.F90:101-199)
# --------------------------------------------------------------------------
def _with_row(x: torch.Tensor, i: int, row: torch.Tensor) -> torch.Tensor:
    """x with x[i] replaced by row, as a new tensor."""
    return torch.cat([x[:i], row[None], x[i + 1:]], 0)


def _dvd(state: OceanState, mesh: MeshTables, cfg, advect, t, tAB, rec,
         dttf_h, dttf_v) -> OceanState:
    """The discrete variance decay of the first ``dvd_h.shape[0]`` tracers
    (Klingbeil et al. 2014 eq. 23; ref gen_modules_diag.F90:744-838;
    ``fesom2_tpu/model.py:649-663``): the squared face values advected by
    ``advect`` (a second advection pass, of moment 2) less the square of
    the advected field, horizontal and vertical apart, per second.  t, tAB,
    rec (MUSCL's folded gradients of tAB, or None) and (dttf_h, dttf_v)
    are the first pass's; the tracers are independent rows, so their first
    rows are what JAX computes anew for the DVD tracers."""
    nd = state.dvd_h.shape[0]
    dt = cfg.dt
    td, tABd = t[:nd], tAB[:nd]
    if rec is not None:
        rec = (rec[0][:nd], rec[1][:nd])
    d2h, d2v = advect(td, tABd, rec, moment=2)
    nmask = mesh.node_layer_mask
    hN = torch.where(nmask, state.hnode_new, 1.0)
    adv1_h = (tABd * state.hnode + dttf_h[:nd]) / hN
    adv1_v = (td * state.hnode + dttf_v[:nd]) / hN
    tgt2_h = (tABd ** 2 * state.hnode + d2h) / hN
    tgt2_v = (td ** 2 * state.hnode + d2v) / hN
    return replace(
        state, dvd_h=torch.where(nmask, (tgt2_h - adv1_h ** 2) / dt, 0.0),
        dvd_v=torch.where(nmask, (tgt2_v - adv1_v ** 2) / dt, 0.0))


def solve_tracers(state: OceanState, mesh: MeshTables, cfg,
                  st: TracerStatics, forcing: Forcing, is_nonlinfs: float,
                  sst: Optional[soufflet.SouffletStatics] = None, fer=None,
                  redi=None, sw_3d=None, clim=None,
                  ptr_masks=None) -> OceanState:
    """All tracers advance together, stacked [T, nl-1, N]
    (``fesom2_tpu/model.py:481-758``): the salt plume; advection by the
    horizontal scheme (MUSCL, MFCT or upwind) and the vertical one (QR4C,
    PPM, CDIFF or upwind), with the FCT limiter (the low-order solution
    implicit in the w split's w_i) or without it (``tra_adv_lim`` other
    than 'FCT'; w_i then joins the implicit vertical diffusion);
    horizontal diffusion with the Redi terms; implicit vertical diffusion
    (none with ``i_vert_diff`` off) with the Redi K33, the shortwave and
    KPP nonlocal sources and salinity on Kv_s under double diffusion; the
    relaxation of T and S to climatology in the sponge (``clim``: (Tclim,
    Sclim, relax2clim)); the region-restored passive tracers held at 1 in
    their regions (``ptr_masks``: [(index, node mask)]); soufflet
    relaxation and the salinity clamp.  ``fer`` are the GM bolus velocities, which advect
    tracers only (ref :126-136)."""
    dt = cfg.dt
    if cfg.dyn.SPP:
        # the brine of growing ice (ref oce_ale_tracer.F90:120-121)
        state = replace(state, tr=_with_row(
            state.tr, 1, tracers.salt_plume(state.tr[1], state, mesh,
                                            forcing, cfg)))
    eps = cfg.dyn.epsilon
    nmask = mesh.node_layer_mask
    av = torch.where(mesh.areasvol[:-1] > 0, mesh.areasvol[:-1], 1.0)
    ntr = cfg.tra.num_tracers
    tids = [cfg.tra.tracer_ID[i] if i < len(cfg.tra.tracer_ID) else i
            for i in range(ntr)]
    use_fct = cfg.tra.tra_adv_lim == "FCT"
    hor = cfg.tra.tra_adv_hor if cfg.tra.tra_adv_hor in ("MUSCL", "MFCT") \
        else "UPW1"
    t = state.tr[:ntr]
    adv_u, adv_v, adv_we, adv_w = state.u, state.v, state.w_e, state.w
    if fer is not None:
        adv_u, adv_v = adv_u + fer[0], adv_v + fer[1]
        adv_we, adv_w = adv_we + fer[2], adv_w + fer[2]

    vflux = tracers._edge_vflux(adv_u, adv_v, state.helem, mesh)
    ver = cfg.tra.tra_adv_ver

    def advect(t, tAB, rec, moment=1):
        """(dttf_h, dttf_v) of the advection of t (``tAB`` its AB
        interpolation, ``rec`` the folded MUSCL gradients of tAB):
        ``run_adv`` of ``fesom2_tpu/model.py:525-599``.  Moment 2 advects
        the squares of the face values, for the DVD diagnostic."""
        tm = tracers._mpow(t, moment)
        if use_fct:
            flux_v_lo = tracers.adv_ver_upw1(t, adv_we, mesh, moment=moment)
            flux_h_lo, flux_h = tracers.adv_hor_lo_ho(
                t, tAB, vflux, mesh, st, rec, cfg.tra.tra_adv_ph, scheme=hor,
                moment=moment)
            lo_h = edge_divergence(flux_h_lo, mesh)
            fct_lo = (tm * state.hnode
                      + (lo_h + (flux_v_lo[..., :-1, :]
                                 - flux_v_lo[..., 1:, :])) * dt / av) \
                / torch.where(nmask, state.hnode_new, 1.0)
            fct_lo = torch.where(nmask, fct_lo, 0.0)
            if cfg.dyn.w_split:
                # the low-order solution takes the implicit part too; the
                # high-order flux is then taken against the full-w upwind
                # flux
                fct_lo = tracers.adv_vert_impl(fct_lo, state.w_i,
                                               state.hnode_new, mesh, dt)
                flux_v_lo = tracers.adv_ver_upw1(t, adv_w, mesh,
                                                 moment=moment)
            w_ho, fp = adv_w, flux_v_lo
        else:
            w_ho, fp = adv_we, None
            if hor != "UPW1":
                flux_h = tracers.adv_hor_muscl_r(
                    tAB, vflux, mesh, st, rec, cfg.tra.tra_adv_ph,
                    boundary_fallback=(hor == "MUSCL"), moment=moment)
            else:
                flux_h = tracers.adv_hor_upw1(tAB, adv_u, adv_v, state.helem,
                                              mesh, vflux=vflux,
                                              moment=moment)
        if ver == "QR4C":
            flux_v = tracers.adv_ver_qr4c(tAB, w_ho, state.Z_3d,
                                          state.zbar_3d, mesh,
                                          cfg.tra.tra_adv_pv, flux_prev=fp,
                                          moment=moment)
        elif ver == "PPM":
            flux_v = tracers.adv_ver_ppm(tAB, w_ho, state.hnode,
                                         state.hnode_new, mesh, dt,
                                         flux_prev=fp, moment=moment)
        elif ver == "CDIFF":
            flux_v = tracers.adv_ver_cdiff(tAB, w_ho, mesh, flux_prev=fp,
                                           moment=moment)
        else:
            flux_v = tracers.adv_ver_upw1(tAB, w_ho, mesh, flux_prev=fp,
                                          moment=moment)
        if use_fct:
            flux_h, flux_v = tracers.fct_limiter(tm, fct_lo, flux_h, flux_v,
                                                 mesh, dt)
            return tracers.flux2dtracer(
                flux_h, flux_v, mesh, dt, ttf=tm, lo=fct_lo,
                hnode=state.hnode, hnode_new=state.hnode_new)
        return tracers.flux2dtracer(flux_h, flux_v, mesh, dt)

    # ---- stage 1: advection + explicit diffusion --------------------------
    # AB interpolation (init_tracers_AB, oce_tracer_mod.F90:48-62)
    tAB = -(0.5 + eps) * state.tr_old[:ntr] + (1.5 + eps) * t
    gxc, gyc = tracers.tracer_gradient_elements(torch.cat([tAB, t], 0), mesh)
    gx, gy = gxc[ntr:], gyc[ntr:]
    rec = tracers.fill_up_dn_grad_r(gxc[:ntr], gyc[:ntr], mesh, st) \
        if hor != "UPW1" else None
    dttf_h, dttf_v = advect(t, tAB, rec)
    if cfg.diag.ldiag_DVD and state.dvd_h.shape[0] > 0:
        with record_function("step.tracers.dvd"):
            state = _dvd(state, mesh, cfg, advect, t, tAB, rec, dttf_h,
                         dttf_v)
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
    if cfg.tra.i_vert_diff:
        surf_bc = torch.stack([
            tracers.bc_surface(tids[i],
                               take_row(t_expl[i], mesh.ulevels_node - 1),
                               forcing, dt, is_nonlinfs)
            for i in range(ntr)])
        src = _tracer_sources(t_expl, state, mesh, cfg, forcing, tids, av,
                              sw_3d)
        kw = dict(w_i=state.w_i if (not use_fct and cfg.dyn.w_split)
                  else None)
        if redi is not None:
            kw.update(Ki_layered=redi[1], slope3=redi[0][2])
        scheme = cfg.dyn.mix_scheme.upper()
        use_dd = (cfg.tra.double_diffusion and scheme == "KPP") \
            or "CVMIX_DDIFF" in scheme

        def solve(sel, Kv):
            return tracers.diff_ver_impl(
                t_expl[sel], Kv, state.hnode_new, mesh.zbar_n_bot, mesh, dt,
                surf_bc[sel], sw_source=None if src is None else src[sel],
                **kw)
        # salinity diffuses with the double-diffusive Kv_s, the others
        # with Kv: one solve for each diffusivity
        sal = [i for i in range(ntr) if use_dd and tids[i] == 1]
        if sal:
            rest = [i for i in range(ntr) if i not in sal]
            tr = torch.empty_like(t_expl)
            tr[sal] = solve(sal, state.Kv_s)
            if rest:
                tr[rest] = solve(rest, state.Kv)
        else:
            tr = solve(slice(None), state.Kv)
    else:
        tr = t_expl

    # relax to the T/S climatology in the sponge (ref relax_to_clim,
    # oce_tracer_mod.F90:87-119)
    if clim is not None:
        for i in range(min(2, ntr)):
            if tids[i] in (0, 1):
                t_i = tr[i] + clim[2][None, :] * dt * (clim[tids[i]] - tr[i])
                tr = _with_row(tr, i, torch.where(nmask, t_i, 0.0))

    # the region-restored passive tracers: held at 1 in their region
    # (ref oce_ale_tracer.F90:159-161)
    for i, pmask in ptr_masks or ():
        tr = _with_row(tr, i, torch.where(pmask[None, :] & nmask, 1.0, tr[i]))
    state = replace(state, tr=tr, tr_old=t)

    # relax to the zonal profile (ref :149-155)
    if sst is not None:
        _, ztem = soufflet.zonal_means(state, mesh, sst)
        state = replace(state, tr=soufflet.relax_zonal_temp(state, mesh, sst,
                                                            dt, ztem))

    # salinity clamp [3, 45] psu (ref :176-198)
    if ntr >= 2:
        state = replace(state, tr=_with_row(
            state.tr, 1, torch.where(nmask, torch.clamp(state.tr[1], 3.0,
                                                        45.0), 0.0)))
    return state


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
# the coupled ocean + ice step
# --------------------------------------------------------------------------
def coupled_step_impl(model: Model, ice_update: bool = True):
    """Ocean+ice step following the reference hot loop (fvom_main.F90:199-268):
    ocean2ice -> ice_timestep -> oce_fluxes_mom/oce_fluxes -> ocean step.

    ``ice_update=False`` builds the sequential-ice variant (ice_ave_steps >
    1, ``fvom_main.F90:231-239``): the ice state is NOT stepped, but the
    ocean still receives the fluxes computed from the (held) ice state; the
    ice catches up with ice_dt = ice_ave_steps * dt on update steps.

    Under ice-shelf cavities (``cfg.run.use_cavity``, ``fesom2_tpu/
    model.py:356-403``) no sea ice stays at a cavity node, the drag of the
    shelf base replaces the surface stress on cavity elements, the
    3-equation melt fluxes replace the heat and water fluxes at cavity
    nodes (no virtual, relaxation or real salt flux there) and no
    shortwave reaches the ocean through the shelf; the span
    ``step.cavity`` holds this work.

    With ``cfg.run.use_icepack`` the ice step is the multi-category Icepack
    column physics (``ice/icepack``, ``cfg.icepack`` an IcepackConfig; ref
    icedrv hook at ice_setup_step.F90:188-189), its EVP on the whole mesh,
    and the impl takes and returns the IcepackState.

    Returns impl(state, ice, ocean_forcing, ice_forcing[, ipk, yday]) ->
    (state, ice[, ipk], ocean_forcing)."""
    cfg = model.cfg
    check_slice(cfg)
    use_virt_salt = cfg.ale.which_ALE == "linfs"
    use_cavity = cfg.run.use_cavity
    use_icepack = cfg.run.use_icepack
    if use_icepack:
        from .ice.icepack import IcepackConfig, icepack_timestep
        if not isinstance(cfg.icepack, IcepackConfig):
            raise ValueError("cfg.run.use_icepack needs cfg.icepack, an "
                             "ice.icepack.IcepackConfig")

    def step_impl(state: OceanState, ice: IceState, ocean_forcing: Forcing,
                  ice_forcing: IceForcing, ipk=None, yday=None):
        mesh = model.mesh
        surf = ice_cpl.ocean2ice(state, mesh)
        if not ice_update:
            pass            # hold the ice state this step (sequential ice)
        elif use_icepack:
            ipk, ice = icepack_timestep(
                ipk, ice, mesh, ice_forcing, surf, cfg, cfg.icepack,
                use_virt_salt, ref_sss=cfg.tra.ref_sss,
                ref_sss_local=cfg.tra.ref_sss_local, yday=yday)
        else:
            ice = ice_timestep(ice, mesh, ice_forcing, surf, cfg,
                               use_virt_salt, ref_sss=cfg.tra.ref_sss,
                               ref_sss_local=cfg.tra.ref_sss_local,
                               sub=model.ice_sub)
        if use_cavity:
            with record_function("step.cavity"):
                ice = cavity.cavity_ice_clean(ice, mesh)
                # the drag of the shelf base against the top layer's flow
                # (ref ice_oce_coupling.F90:75) and the 3-equation melt
                # fluxes (:222), of the state before this step
                cav_e = mesh.ulevels_elem > 1
                cav_n = mesh.ulevels_node > 1
                csx, csy = cavity.cavity_momentum_fluxes(state, mesh, cfg)
                chf, cwf = cavity.cavity_heat_water_fluxes_3eq(
                    state, mesh, model.density_ref)
        with record_function("step.fluxes"):
            sx, sy = ice_cpl.oce_fluxes_mom(ice, surf, ice_forcing, mesh, cfg)
            if use_cavity:
                sx = torch.where(cav_e, csx, sx)
                sy = torch.where(cav_e, csy, sy)
            ocean_forcing = replace(ocean_forcing, stress_x=sx, stress_y=sy)
            ocean_forcing = ice_cpl.oce_fluxes(
                ice, surf, ice_forcing, ocean_forcing, mesh, cfg,
                use_virt_salt, Ssurf=model.Ssurf, ref_sss=cfg.tra.ref_sss,
                ref_sss_local=cfg.tra.ref_sss_local)
            if use_cavity:
                # the melt fluxes in place of the absent atmosphere's
                of = ocean_forcing
                ocean_forcing = replace(
                    of, heat_flux=torch.where(cav_n, chf, of.heat_flux),
                    water_flux=torch.where(cav_n, cwf, of.water_flux),
                    virtual_salt=torch.where(cav_n, 0.0, of.virtual_salt),
                    relax_salt=torch.where(cav_n, 0.0, of.relax_salt),
                    real_salt_flux=torch.where(cav_n, 0.0,
                                               of.real_salt_flux))
            # ice fields + atm stress for Monin-Obukhov mixing
            # (oce_mo_conv.F90)
            ocean_forcing = replace(
                ocean_forcing, stress_atm_x=ice_forcing.stress_atmoce_x,
                stress_atm_y=ice_forcing.stress_atmoce_y,
                u_ice=ice.u_ice, v_ice=ice.v_ice, a_ice=ice.a_ice,
                thdgr=ice.thdgr, m_ice=ice.m_ice, m_snow=ice.m_snow)
            # shortwave penetration below open water
            # (ref ice_oce_coupling.F90:338)
            sw_3d = None
            if cfg.run.use_sw_pene:
                sw_3d, dheat = tracers.shortwave_penetration(
                    ice_forcing.shortwave, ice.a_ice, state.zbar_3d, mesh,
                    cfg.ice.albw)
                if use_cavity:
                    # no shortwave reaches the ocean through a shelf
                    sw_3d = torch.where(cav_n[None, :], 0.0, sw_3d)
                    dheat = torch.where(cav_n, 0.0, dheat)
                ocean_forcing = replace(
                    ocean_forcing, heat_flux=ocean_forcing.heat_flux + dheat)
        state = model(state, ocean_forcing, sw_3d)
        if use_icepack:
            return state, ice, ipk, ocean_forcing
        return state, ice, ocean_forcing

    return step_impl


def coupled_step_fn(model: Model):
    """Public coupled step: step(state, ice, ocean_forcing, ice_forcing[,
    ipk]) -> (state, ice[, ipk], ocean_forcing), without gradients (the
    IcepackState with ``cfg.run.use_icepack``)."""
    return torch.no_grad()(coupled_step_impl(model))


def pi_coupled_parts(model: Model, atm: AtmData, ice_update: bool = True):
    """The coupled step with its forcing update, and what it reads beside
    the model: impl(state, ice, step_idx, SP[, ipk]) -> (state, ice[, ipk],
    ocean_forcing), with SP = {"atm", "base_ice_forcing",
    "base_oce_forcing", "tide_offset"} returned alongside.  Model time is
    step_idx * dt from the start of the forcing's time axes.  Under
    ``use_global_tides`` the ocean forcing carries the tidal potential of
    the step (``forcing/tides.py``; ``fesom2_tpu/model.py:964-1003``),
    counted in steps from 2000-01-01 from the start of
    ``cfg.clock.yearnew``'s month of ``daynew``.  Under
    ``cfg.run.use_icepack`` the Icepack step gets the fractional day of
    the year (its first-year-ice reset; ``fesom2_tpu/model.py:990-995``)."""
    cfg = model.cfg
    check_slice(cfg)
    coupled = coupled_step_impl(model, ice_update=ice_update)
    use_tides = cfg.run.use_global_tides
    use_icepack = cfg.run.use_icepack
    tide_offset = None
    if use_tides:
        start_month = 1 + (cfg.clock.daynew - 1) // 31
        tide_offset = tides.foreph_offset(cfg.clock.yearnew, start_month,
                                          cfg.dt)

    def step_impl(state: OceanState, ice: IceState, step_idx, SP, ipk=None):
        mesh = model.mesh
        with record_function("step.forcing"):
            if isinstance(step_idx, torch.Tensor):
                step_idx = step_idx.to(model.dtype)
            t_sec = step_idx * cfg.dt
            surf = ice_cpl.ocean2ice(state, mesh)
            ice_forcing = update_atm_forcing(
                SP["atm"], t_sec, ice.u_ice, ice.v_ice, surf.u_w, surf.v_w,
                surf.T_oc, SP["base_ice_forcing"])
            oce_forcing = SP["base_oce_forcing"]
            if use_tides:
                # ref fvom_main.F90:199-202: foreph increments mmccdt first;
                # the counter in the model's dtype, as in the JAX package
                idx = step_idx if isinstance(step_idx, torch.Tensor) \
                    else torch.full((), float(step_idx), dtype=model.dtype)
                ssh_gp = tides.tidal_potential(
                    SP["tide_offset"] + idx + 1.0, cfg.dt,
                    mesh.geo_coords[:, 0], mesh.geo_coords[:, 1])
                oce_forcing = replace(oce_forcing, ssh_gp=ssh_gp)
        if use_icepack:
            # the fractional day of the year
            yday = (cfg.clock.daynew - 1.0 + t_sec / 86400.0) % 365.0 + 1.0
            return coupled(state, ice, oce_forcing, ice_forcing, ipk,
                           yday=yday)
        return coupled(state, ice, oce_forcing, ice_forcing)

    SP = dict(atm=atm,
              base_ice_forcing=zero_ice_forcing(model.mesh, model.dtype),
              base_oce_forcing=zero_forcing(model.mesh, model.dtype),
              tide_offset=tide_offset)
    return step_impl, SP


def pi_coupled_step_fn(model: Model, atm: AtmData):
    """Full coupled step with the atmospheric forcing updated on the
    device: step(state, ice, step_idx[, ipk]) -> (state, ice[, ipk],
    ocean_forcing), without gradients; ``step_idx`` is an int (or a 0-d
    tensor when ``ice_ave_steps`` is 1); ``ipk`` and the returned
    IcepackState with ``cfg.run.use_icepack``.

    With ``ice_ave_steps > 1`` (sequential ice, fvom_main.F90:231-239) the
    ice is stepped when (step_idx + 1) % ice_ave_steps == 0 and held
    otherwise; the ocean receives the held ice's fluxes."""
    ave = max(1, int(model.cfg.ice.ice_ave_steps))
    step_impl, SP = pi_coupled_parts(model, atm)
    step_hold = pi_coupled_parts(model, atm, ice_update=False)[0] \
        if ave > 1 else None
    use_icepack = model.cfg.run.use_icepack

    @torch.no_grad()
    def step(state: OceanState, ice: IceState, step_idx, ipk=None):
        update = ave == 1 or (int(step_idx) + 1) % ave == 0
        impl = step_impl if update else step_hold
        if use_icepack:
            return impl(state, ice, step_idx, SP, ipk)
        return impl(state, ice, step_idx, SP)

    return step


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
    ring (linfs) or ALE ring (zlevel, zstar) operator of the CG solve
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
                         cfg: Optional[ModelConfig] = None,
                         pad_to: int = 1) -> Model:
    """Build the soufflet channel model on ``device``.

    ``mesh_path``: a FESOM mesh directory; None builds the default channel
    in code (``mesh/channel.py``: 25 x 115 nodes, 40 layers of 100 m).
    ``which_ale``: "linfs", "zlevel" or "zstar" (ignored when ``cfg`` is
    given).
    Meshes up to ``DENSE_SSH_MAX_NODES`` nodes get the dense SSH inverse,
    larger ones the CG tables (``_ssh_solver``).  ``pad_to > 1`` pads the
    node, element and edge counts to a multiple of it with dummy entities
    (``parallel/padding.py``).
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
    if pad_to > 1:
        mesh = pad_mesh(mesh, pad_to)
    tst = build_tracer_statics(mesh, K_hor=cfg.tra.K_hor, dtype=dtype)
    Z3 = mesh.Z[:, None].expand(mesh.nl - 1, mesh.n_nodes)
    dref = eos.reference_density(mesh, Z3, cfg.dyn.state_equation,
                                 toy_soufflet=True)
    _, _, sst = soufflet.setup_soufflet(mesh, dtype)
    return Model(mesh, cfg, tst, dref, sst, **_ssh_solver(mesh, cfg, dtype))


def pi_config(parity: str = "ci", step_per_day: int = 96) -> ModelConfig:
    """The configuration ``fesom2_tpu.model.setup_pi_model`` builds
    (``fesom2_tpu/model.py:793-839``), field for field.  Both parities
    share JM, ``visc_option=5``, ``w_split`` with ``w_max_cfl=1``,
    MFCT/QR4C/FCT, shortwave penetration and ``force_rotation``.
    ``"ci"`` is the reference CI configuration: zstar, partial cells with
    threshold 0, KPP, Fer_GM + Redi with the CI values, ``K_hor=3000``,
    the CI viscosity and relaxation.  ``"fast"`` (``bench.py``'s
    ``BENCH_PARITY=fast``) is linfs + PP with every other field at its
    default: full cells, no GM/Redi.  Any other parity raises.

    The ice is on (mEVP, 120 subcycles, on the subdomain poleward of 40
    degrees); a caller who wants the ocean alone (``run.run_pi_ocean``)
    may set ``cfg.run.use_ice = False`` before ``setup_pi_model``.
    """
    if parity not in ("ci", "fast"):
        raise ValueError(f"parity must be 'ci' or 'fast', not {parity!r}")
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
    if parity == "fast":
        cfg.ale.which_ALE = "linfs"
        cfg.dyn.mix_scheme = "PP"
        return cfg
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
                   step_per_day: int = 96, parity: str = "ci",
                   cfg: Optional[ModelConfig] = None, atm_seed: int = 0,
                   cavity_depth=None, n_refine: int = 0,
                   forcing_path: Optional[str] = None, pad_to: int = 1):
    """The global ocean + ice configuration on ``device``, as
    ``fesom2_tpu/model.py:setup_pi_model`` and ``_finish_pi_setup``
    (:764-911) build it.  Returns (Model, AtmData):

    1. the mesh tables with ``force_rotation``, a cyclic length of 360
       degrees and the configuration's partial cells; ``cavity_depth``
       [N] (an ice-shelf draft, negative, 0 in open ocean; it replaces the
       directory's ``cavity_depth.out``) puts cavities under the shelf
       and turns ``cfg.run.use_cavity`` on; ``n_refine > 0`` refines the
       mesh 4-way that many times (``mesh/refine.py``), with the draft of
       the directory's ``cavity_depth.out`` if it has one.  As in the JAX
       package, a ``cavity_depth`` given with ``n_refine > 0`` turns
       ``use_cavity`` on but does not reach the refined mesh (where the
       mesh has no cavity, the cavity branches change nothing);
    2. the tracer statics;
    3. the unperturbed ``initial_z3d`` and the reference density on its
       mid depths (partial cells move the bottom layer's);
    4. the dense SSH inverse, or the block preconditioner and the ALE
       ring (linfs: ring) of the CG solve above ``DENSE_SSH_MAX_NODES``;
    5. the ice subdomain where ``cfg.ice.evp_subdomain_lat`` is set and
       the ice is on;
    6. the atmosphere.  With ``forcing_path`` it is read from files as
       the JAX package reads it (``fesom2_tpu/model.py:890-911``): the
       ``&nam_sbc`` layout of ``cfg.sbc`` where it is configured and its
       file of ``cfg.clock.yearnew`` exists, else the NCEP test set under
       ``forcing_path`` (``ncep_test_sbc``: ``u_10.<year>.nc``, ...,
       ``runoff.nc``), for 1948 and with ``y_perpetual`` where the clock's
       year has no file; ``model.sbc`` keeps the source for ``run_pi``'s
       year switch.  Without it no files are read and the series are
       built in code on the mesh (``globe_atm_data`` with ``atm_seed``).

    ``cfg`` defaults to ``pi_config(parity, step_per_day)``; ``pad_to >
    1`` pads the mesh's entity counts to a multiple of it after step 1
    (``parallel/padding.py``; ``fesom2_tpu/model.py:861-863``).
    """
    device = _check_device(device)
    if cfg is None:
        cfg = pi_config(parity, step_per_day)
    check_slice(cfg)
    pc = dict(use_partial_cell=cfg.ale.use_partial_cell,
              partial_cell_thresh=cfg.ale.partial_cell_thresh)
    if n_refine > 0:
        mesh = refined_mesh(mesh_path, n_refine, force_rotation=True,
                            cyclic_length_deg=360.0, dtype=dtype,
                            device=device, **pc)
    else:
        mesh = build_mesh(mesh_path, force_rotation=True,
                          cyclic_length_deg=360.0, cavity_depth=cavity_depth,
                          dtype=dtype, device=device, **pc)
    if cavity_depth is not None:
        cfg.run.use_cavity = True
    if pad_to > 1:
        mesh = pad_mesh(mesh, pad_to)
    tst = build_tracer_statics(mesh, K_hor=cfg.tra.K_hor, dtype=dtype)
    _, Z3 = initial_z3d(mesh, dtype)
    dref = eos.reference_density(mesh, Z3, cfg.dyn.state_equation)
    sub = None
    if cfg.run.use_ice and cfg.ice.evp_subdomain_lat is not None:
        sub = build_ice_subdomain(mesh, lat_deg=cfg.ice.evp_subdomain_lat)
    model = Model(mesh, cfg, tst, dref, ice_sub=sub,
                  **_ssh_solver(mesh, cfg, dtype))
    if forcing_path is None:
        return model, globe_atm_data(model, seed=atm_seed)
    year = cfg.clock.yearnew
    if cfg.sbc.configured and os.path.exists(
            f"{cfg.sbc.nm_xwind_file}{year}.nc"):
        sbc = cfg.sbc
    else:
        sbc = ncep_test_sbc(forcing_path)
        if not os.path.exists(f"{sbc.nm_xwind_file}{year}.nc"):
            # the test set covers 1948 only: other clock years reuse it
            # (&nam_sbc y_perpetual), so run_pi builds no provider
            sbc = replace(sbc, y_perpetual=True)
            year = 1948
    model.sbc = sbc
    return model, load_sbc_forcing(mesh, sbc, year=year, dtype=dtype)


def globe_atm_data(model: Model, seed: int = 0, n_records: int = 4) -> AtmData:
    """The code-built atmosphere of ``mesh.globe.globe_atm_fixtures`` on
    ``model``'s mesh, at its dtype and device."""
    mesh = model.mesh
    fx = globe_atm_fixtures(host(mesh.geo_coords[:, 1]), seed=seed,
                            n_records=n_records)
    return AtmData(**{k: torch.as_tensor(v, device=mesh.zbar.device)
                      .to(model.dtype) for k, v in fx.items()})


def globe_ocean_fixtures(model: Model, seed: int = 0) -> dict:
    """``mesh.globe.globe_fixtures`` (T, S and the surface forcing, numpy)
    on ``model``'s mesh."""
    mesh = model.mesh
    return globe_fixtures(host(mesh.geo_coords[:, 1]), host(mesh.elem_nodes),
                          host(mesh.Z), host(mesh.nlevels_node),
                          host(mesh.area[0]), seed=seed)


def pi_initial_state(model: Model, seed: int = 0,
                     forcing_path: Optional[str] = None):
    """Ocean + ice initial state (``fesom2_tpu/model.py:914-948``): the
    column at rest with the temperature and salinity of the WOA18
    climatology ``forcing_path/woa18_netcdf_5deg.nc`` (``core/ic.py``:
    ``climatology_ic``, potential temperature), or without a path those of
    the globe fixtures of ``seed``; and the reference's ice_initial_state
    (``ice_setup_step.F90:284-330``): ice where the surface is colder than
    0 C, 1 m (north) or 2 m (south) thick under 0.1 m or 0.5 m of snow, at
    a concentration of 0.9.  Sets ``model.Ssurf`` (the SSS relaxation's
    target) and the climatology of relax_to_clim, ``model.Tclim`` and
    ``model.Sclim``, to the initial T and S with ``model.relax2clim`` 0
    (ref oce_setup_step.F90:479-484): a sponge is the caller's to set.
    Returns (state, ice)."""
    mesh = model.mesh
    dev, dtype = mesh.zbar.device, model.dtype
    state = model.initial_state()
    tr = state.tr.clone()
    if forcing_path is not None:
        T, S = climatology_ic(mesh, os.path.join(forcing_path,
                                                 "woa18_netcdf_5deg.nc"))
        tr[0] = torch.from_numpy(T).to(device=dev, dtype=dtype)
        tr[1] = torch.from_numpy(S).to(device=dev, dtype=dtype)
    else:
        fx = globe_ocean_fixtures(model, seed)
        # no water above an ice-shelf cavity's top
        nmask = mesh.node_layer_mask
        tr[0] = torch.where(nmask, torch.as_tensor(fx["T"], device=dev)
                            .to(dtype), 0.0)
        tr[1] = torch.where(nmask, torch.as_tensor(fx["S"], device=dev)
                            .to(dtype), 0.0)
    state = replace(state, tr=tr, tr_old=tr)
    model.Ssurf = tr[1, 0].clone()
    model.Tclim, model.Sclim = tr[0].clone(), tr[1].clone()
    model.relax2clim = torch.zeros_like(tr[1, 0])

    ice = allocate_ice(mesh, dtype)
    cold = tr[0, 0] < 0.0
    north = mesh.geo_coords[:, 1] > 0
    const = lambda value: torch.full_like(ice.m_ice, value)
    ice = replace(
        ice,
        m_ice=torch.where(cold, torch.where(north, const(1.0), const(2.0)),
                          0.0),
        m_snow=torch.where(cold, torch.where(north, const(0.1), const(0.5)),
                           0.0),
        a_ice=torch.where(cold, const(0.9), 0.0))
    return state, ice
