"""The port's sea ice against the JAX package, function by function, on the
level-3 globe with 12 layers (CPU, float64).

The same numpy inputs, made from a seed, go through the JAX function
(jitted, as its own tests run it) and the port's: ``elem_contrib_to_nodes``
in both layouts, the ice subdomain's tables, ``ocean2ice`` and the flux
assembly, the thermodynamics, mEVP dynamics on the whole mesh and on the
polar-cap subdomain, the FCT advection and ``ice_timestep``.  Every output
agrees to 1e-10 of its largest JAX magnitude.

Rounding growth over the mEVP subcycles was measured before that
tolerance was fixed (``test_mevp_dynamics`` prints it; run it with ``-s``):
port against JAX after 1, 8 and 120 subcycles differs by 2.8e-16, 1.1e-15
and 5.2e-15 of max|JAX| in the velocities and 1.4e-16, 5.7e-16 and 7.1e-15
in the stresses.  The subcycle relaxes towards a fixed point, so last-bit
differences grow no faster than the count of subcycles.

The CUDA kernels cannot run here.  Their data flow (a thread per node
walks its slots in the order k = 0..K-1 and skips the padded ones; a
thread per element writes its three vertices' shares vertex-major) is
emulated node by node and element by element in numpy and held bit for bit
against the plain versions, which add in the same slot order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_tpu.core import ops as jops
from fesom2_tpu.core.state import allocate_state as jalloc, \
    init_thickness_linfs as jinit, zero_forcing as jzero_forcing
from fesom2_tpu.ice import coupling as jcpl, evp as jevp, fct as jfct, \
    step as jstep, thermo as jthermo
from fesom2_tpu.ice.state import IceForcing as JIceForcing, \
    IceState as JIceState, OceanSurface as JOceanSurface
from fesom2_tpu.ice.subdomain import build_ice_subdomain as jbuild_sub
from fesom2_tpu.mesh import build_mesh as jax_build_mesh

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.convert import (forcing_from_numpy,
                                      ice_forcing_from_numpy,
                                      ice_state_from_numpy,
                                      ice_subdomain_from_numpy,
                                      state_from_numpy)
from fesom2_tpu_torch.core import ops
from fesom2_tpu_torch.ice import coupling, evp, fct, thermo
from fesom2_tpu_torch.ice.state import OceanSurface, allocate_ice, \
    zero_ice_forcing
from fesom2_tpu_torch.ice.step import ice_timestep
from fesom2_tpu_torch.ice.subdomain import build_ice_subdomain
from fesom2_tpu_torch.mesh import build_mesh, globe
from fesom2_tpu_torch.model import pi_config

from test_torch_kpp import assert_close

PC = dict(force_rotation=True, cyclic_length_deg=360.0,
          use_partial_cell=True, partial_cell_thresh=0.0)
ICE_FIELDS = [f.name for f in dataclasses.fields(JIceState)]


def arrays_of(obj) -> dict:
    return {f.name: getattr(obj, f.name)
            if isinstance(getattr(obj, f.name), int)
            else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def t(x):
    return torch.tensor(np.asarray(x))


def seeded_ice_inputs(geo_lat, n_elems, seed=11):
    """Numpy dicts of an ice state, an ice forcing and an ocean surface:
    ice poleward of 55 degrees with seeded thickness, concentration, snow,
    drift and stresses; some nodes just under the 0.01 concentration
    threshold; none equatorward."""
    rng = np.random.default_rng(seed)
    N = geo_lat.shape[0]
    polar = np.abs(np.degrees(geo_lat)) > 55.0
    u = lambda lo, hi, n=N: rng.uniform(lo, hi, n)
    a_ice = np.where(polar, u(0.3, 1.0), 0.0)
    thin = polar & (rng.uniform(size=N) < 0.15)
    a_ice = np.where(thin, 0.009, a_ice)
    ice = dict(
        u_ice=np.where(polar, u(-0.1, 0.1), 0.0),
        v_ice=np.where(polar, u(-0.1, 0.1), 0.0),
        m_ice=np.where(polar, u(0.3, 2.5), 0.0), a_ice=a_ice,
        m_snow=np.where(polar, u(0.0, 0.4), 0.0),
        sigma11=u(-200.0, 200.0, n_elems), sigma12=u(-200.0, 200.0, n_elems),
        sigma22=u(-200.0, 200.0, n_elems), t_skin=u(-20.0, 0.0),
        fresh_wa_flux=u(-1e-7, 1e-7), net_heat_flux=u(-100.0, 100.0),
        real_salt_flux=np.zeros(N), evaporation=u(-1e-8, 1e-8),
        thdgr=u(-1e-7, 1e-7), thdgrsn=u(-1e-8, 1e-8), flice=np.zeros(N),
        a_ice_old=a_ice.copy(), alpha_aevp=np.full(n_elems, 250.0),
        beta_aevp=np.full(N, 250.0))
    c = np.cos(geo_lat)
    forcing = dict(
        shortwave=250.0 * c + u(0.0, 5.0), longwave=230.0 + 100.0 * c,
        Tair=30.0 * c - 14.0 + u(-1.0, 1.0), shum=u(5e-4, 1e-2),
        prec_rain=u(0.0, 2e-8), prec_snow=u(0.0, 1e-8), runoff=u(0.0, 2e-9),
        evaporation_in=np.zeros(N), u_wind=u(-10.0, 10.0),
        v_wind=u(-10.0, 10.0), stress_atmice_x=u(-0.2, 0.2),
        stress_atmice_y=u(-0.2, 0.2), stress_atmoce_x=u(-0.2, 0.2),
        stress_atmoce_y=u(-0.2, 0.2), Ch_atm_oce=u(1e-3, 2e-3),
        Ce_atm_oce=u(1e-3, 2e-3))
    surf = dict(T_oc=26.0 * c ** 2 - 1.5 + u(-0.2, 0.2), S_oc=u(33.0, 35.5),
                u_w=u(-0.05, 0.05), v_w=u(-0.05, 0.05),
                elevation=u(-0.3, 0.3))
    return ice, forcing, surf


class Case:
    """The JAX and the port side of one ice setup."""


def ice_case(path):
    torch.set_num_threads(1)
    c = Case()
    c.path = path
    c.cfg = pi_config()
    c.jmesh = jax_build_mesh(path, **PC)
    c.tmesh = build_mesh(path, device="cpu", **PC)
    ice, forcing, surf = seeded_ice_inputs(
        np.asarray(c.jmesh.geo_coords[:, 1]), c.jmesh.n_elems)
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    c.jice, c.jforcing, c.jsurf = (JIceState(**j(ice)),
                                   JIceForcing(**j(forcing)),
                                   JOceanSurface(**j(surf)))
    c.tice = ice_state_from_numpy(ice, "cpu")
    c.tforcing = ice_forcing_from_numpy(forcing, "cpu")
    c.tsurf = OceanSurface(**{k: t(v) for k, v in surf.items()})
    c.jsub = jbuild_sub(c.jmesh, lat_deg=40.0)
    c.tsub = build_ice_subdomain(c.tmesh, lat_deg=40.0)
    return c


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return ice_case(globe.write_globe(
        str(tmp_path_factory.mktemp("globe")), level=3, n_layers=12,
        dz_bottom=1000.0))


def assert_ice_close(tice, jice, names=ICE_FIELDS, tol=1e-10):
    for name in names:
        assert_close(getattr(tice, name), getattr(jice, name), name, tol=tol)


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------
def test_allocate_ice_and_zero_forcing_match(case):
    from fesom2_tpu.ice.state import allocate_ice as jallocate, \
        zero_ice_forcing as jzero
    for got, want in ((allocate_ice(case.tmesh), jallocate(case.jmesh)),
                      (zero_ice_forcing(case.tmesh), jzero(case.jmesh))):
        assert [f.name for f in dataclasses.fields(got)] \
            == [f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            assert np.array_equal(getattr(got, f.name).numpy(),
                                  np.asarray(getattr(want, f.name))), f.name


# --------------------------------------------------------------------------
# elem_contrib_to_nodes (K1)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rows", [(), (1,), (2,), (3,), (2, 3)])
@pytest.mark.parametrize("vertex_major", [False, True])
def test_elem_contrib_to_nodes(case, rows, vertex_major):
    c = case
    E = c.jmesh.n_elems
    assert int((np.asarray(c.jmesh.nod_in_elem) < 0).sum()) > 0   # padding
    rng = np.random.default_rng(3)
    x = rng.standard_normal(rows + ((3, E) if vertex_major else (E, 3)))
    jfn = jops.elem_contrib_to_nodes_3e if vertex_major \
        else jops.elem_contrib_to_nodes
    tfn = ops.elem_contrib_to_nodes_3e if vertex_major \
        else ops.elem_contrib_to_nodes
    want = jax.jit(lambda a: jfn(a, c.jmesh))(jnp.asarray(x))
    kernels.reset_launches()
    got = tfn(t(x), c.tmesh)
    assert kernels.LAUNCHES["elem_contrib_to_nodes"] == 0
    assert_close(got, want, "elem_contrib_to_nodes", tol=1e-14)


def walk_slots(flat, nie, slot, n_elems, vertex_major):
    """What the kernel's thread (row r, node n) does: the slots in the
    order k = 0..K-1, padded ones skipped, one add each."""
    R, (N, K) = flat.shape[0], nie.shape
    out = np.zeros((R, N), flat.dtype)
    for n in range(N):
        for k in range(K):
            e = nie[n, k]
            if e < 0:
                continue
            s = slot[n, k]
            idx = s * n_elems + e if vertex_major else e * 3 + s
            out[:, n] = out[:, n] + flat[:, idx]
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("vertex_major", [False, True])
def test_elem_contrib_kernel_data_flow_is_the_slot_order_sum(case, dtype,
                                                             vertex_major):
    c = case
    for mesh in (c.tmesh, c.tsub):
        E = mesh.n_elems
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 3, E) if vertex_major
                                else (2, E, 3)).astype(dtype)
        walked = walk_slots(x.reshape(2, -1), mesh.nod_in_elem.numpy(),
                            mesh.nod_in_elem_slot.numpy(), E, vertex_major)
        plain = ops.elem_contrib_to_nodes_plain(torch.tensor(x), mesh,
                                                vertex_major)
        assert np.array_equal(walked, plain.numpy())


def test_elem_contrib_to_nodes_work_counts_bytes():
    # contrib and out once, one int32 slot word a (node, slot)
    nbytes, flops = ops.elem_contrib_to_nodes_work(2, 1000, 600, 7, 8)
    assert nbytes == 2 * (3000 + 600) * 8 + 600 * 7 * 4
    assert flops == 7 * 2 * 600


# --------------------------------------------------------------------------
# subdomain
# --------------------------------------------------------------------------
def test_build_ice_subdomain_tables_equal(case):
    want, got = arrays_of(case.jsub), case.tsub
    assert got.n_nodes == want["n_nodes"] and got.n_elems == want["n_elems"]
    assert 0 < got.n_nodes < case.tmesh.n_nodes
    for name in ("sub_nodes", "sub_elems", "node_mask", "elem_nodes",
                 "nod_in_elem", "nod_in_elem_slot"):
        assert np.array_equal(getattr(got, name).numpy(), want[name]), name
    for name in ("gradient_sca", "metric_factor", "elem_area", "area",
                 "coriolis_node", "bc_index_node"):
        assert_close(getattr(got, name), want[name], name, tol=1e-14)
    # no index twice: the copy out of the subdomain is an indexed assignment
    assert np.unique(want["sub_nodes"]).size == want["n_nodes"]
    assert np.unique(want["sub_elems"]).size == want["n_elems"]
    back = ice_subdomain_from_numpy(want, "cpu")
    assert torch.equal(back.nod_in_elem, got.nod_in_elem)
    assert back.nod_in_elem.dtype == torch.int32 and back.n_elems == got.n_elems


# --------------------------------------------------------------------------
# coupling
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ocean(case):
    """A JAX ocean state with seeded surface fields, and the port's."""
    m = case.jmesh
    rng = np.random.default_rng(8)
    js = jinit(jalloc(m, 2, jnp.float64), m)
    wet_e = np.asarray(m.elem_layer_mask)
    wet_n = np.asarray(m.node_layer_mask)
    js = dataclasses.replace(
        js, u=jnp.asarray(rng.uniform(-0.3, 0.3, wet_e.shape) * wet_e),
        v=jnp.asarray(rng.uniform(-0.3, 0.3, wet_e.shape) * wet_e),
        tr=jnp.asarray(rng.uniform(0.0, 35.0, (2,) + wet_n.shape) * wet_n),
        hbar=jnp.asarray(rng.uniform(-0.4, 0.4, m.n_nodes)))
    return js, state_from_numpy(arrays_of(js), "cpu")


def test_ocean2ice(case, ocean):
    js, ts = ocean
    want = jax.jit(lambda s: jcpl.ocean2ice(s, case.jmesh))(js)
    got = coupling.ocean2ice(ts, case.tmesh)
    for f in dataclasses.fields(want):
        assert_close(getattr(got, f.name), getattr(want, f.name), f.name)
    assert float(got.u_w.abs().max()) > 0.0


def test_oce_fluxes_mom(case):
    c = case
    want = jax.jit(lambda i, s, f: jcpl.oce_fluxes_mom(i, s, f, c.jmesh,
                                                       c.cfg))(
        c.jice, c.jsurf, c.jforcing)
    got = coupling.oce_fluxes_mom(c.tice, c.tsurf, c.tforcing, c.tmesh, c.cfg)
    for name, a, b in zip(("stress_x", "stress_y"), got, want):
        assert_close(a, b, name)


@pytest.mark.parametrize("use_virt_salt", [False, True])
def test_oce_fluxes(case, use_virt_salt):
    c = case
    ssurf = np.asarray(c.jsurf.S_oc)[::-1].copy()
    jf = jzero_forcing(c.jmesh)
    want = jax.jit(lambda i, s, f, of: jcpl.oce_fluxes(
        i, s, f, of, c.jmesh, c.cfg, use_virt_salt, Ssurf=jnp.asarray(ssurf),
        ref_sss=c.cfg.tra.ref_sss, ref_sss_local=True))(
        c.jice, c.jsurf, c.jforcing, jf)
    got = coupling.oce_fluxes(
        c.tice, c.tsurf, c.tforcing, forcing_from_numpy(arrays_of(jf), "cpu"),
        c.tmesh, c.cfg, use_virt_salt, Ssurf=t(ssurf),
        ref_sss=c.cfg.tra.ref_sss, ref_sss_local=True)
    for f in dataclasses.fields(want):
        assert_close(getattr(got, f.name), getattr(want, f.name), f.name)
    assert float(got.relax_salt.abs().max()) > 0.0
    assert (float(got.virtual_salt.abs().max()) > 0.0) == use_virt_salt


# --------------------------------------------------------------------------
# thermodynamics
# --------------------------------------------------------------------------
def test_tfrez():
    S = np.linspace(-1.0, 40.0, 83)
    assert_close(thermo.tfrez(t(S)), jthermo.tfrez(jnp.asarray(S)), "tfrez",
                 tol=1e-14)


@pytest.mark.parametrize("variant", ["with ice", "without ice",
                                     "at the freezing point"])
@pytest.mark.parametrize("use_virt_salt", [False, True])
def test_thermodynamics(case, variant, use_virt_salt):
    c = case
    jice, tice, jsurf, tsurf = c.jice, c.tice, c.jsurf, c.tsurf
    if variant == "without ice":
        z = np.zeros(c.jmesh.n_nodes)
        kw = dict(m_ice=z, a_ice=z, m_snow=z)
        jice = dataclasses.replace(jice, **{k: jnp.asarray(v)
                                            for k, v in kw.items()})
        tice = dataclasses.replace(tice, **{k: t(v) for k, v in kw.items()})
        # a surface a degree colder, under its freezing point at the poles
        cold = np.asarray(jsurf.T_oc) - 1.0
        jsurf = dataclasses.replace(jsurf, T_oc=jnp.asarray(cold))
        tsurf = dataclasses.replace(tsurf, T_oc=t(cold))
    if variant == "at the freezing point":
        tf = np.asarray(jthermo.tfrez(jsurf.S_oc))
        jsurf = dataclasses.replace(jsurf, T_oc=jnp.asarray(tf))
        tsurf = dataclasses.replace(tsurf, T_oc=t(tf))
    want = jax.jit(lambda i, f, s: jthermo.thermodynamics(
        i, c.jmesh, f, s, c.cfg, use_virt_salt, ref_sss=34.0,
        ref_sss_local=True))(jice, c.jforcing, jsurf)
    got = thermo.thermodynamics(tice, c.tmesh, c.tforcing, tsurf, c.cfg,
                                use_virt_salt, ref_sss=34.0,
                                ref_sss_local=True)
    assert_ice_close(got, want)
    grown = float((got.m_ice - tice.m_ice).abs().max())
    assert grown > 0.0
    if variant == "without ice":
        # open water freezes over at the cold nodes only
        assert 0 < int((got.a_ice > 0).sum()) < c.jmesh.n_nodes


# --------------------------------------------------------------------------
# mEVP dynamics (K7)
# --------------------------------------------------------------------------
def subcycle_config(n):
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = n
    return cfg


@pytest.mark.parametrize("n_sub", [1, 8, 120])
def test_mevp_dynamics(case, n_sub):
    c = case
    cfg = subcycle_config(n_sub)
    want = jax.jit(lambda i, f, s: jevp.mevp_dynamics(i, c.jmesh, f, s, cfg))(
        c.jice, c.jforcing, c.jsurf)
    kernels.reset_launches()
    got = evp.mevp_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg)
    assert kernels.LAUNCHES["mevp_stress"] == kernels.LAUNCHES["mevp_node"] == 0
    rel = lambda names: max(
        float(np.abs(getattr(got, k).numpy() - np.asarray(getattr(want, k)))
              .max() / np.abs(np.asarray(getattr(want, k))).max())
        for k in names)
    print(f"mevp_dynamics, {n_sub} subcycles, port against JAX, of max|JAX|: "
          f"velocities {rel(('u_ice', 'v_ice')):.3e}, stresses "
          f"{rel(('sigma11', 'sigma12', 'sigma22')):.3e}")
    assert_ice_close(got, want)
    # ice that moves, under stress; still water where there is none
    assert float(got.u_ice.abs().max()) > 1e-3
    assert float((got.sigma11 - c.tice.sigma11).abs().max()) > 1.0
    no_ice = c.tice.a_ice < 0.01
    assert torch.equal(got.u_ice[no_ice], c.tice.u_ice[no_ice] *
                       c.tmesh.bc_index_node[no_ice])


@pytest.mark.parametrize("n_sub", [1, 8, 120])
def test_ice_dynamics_on_the_subdomain(case, n_sub):
    c = case
    cfg = subcycle_config(n_sub)
    want = jax.jit(lambda i, f, s: jevp.ice_dynamics(
        i, c.jmesh, f, s, cfg, sub=c.jsub))(c.jice, c.jforcing, c.jsurf)
    got = evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg,
                           sub=c.tsub)
    assert_ice_close(got, want)
    # and the whole mesh gives the same answer where the ice is: the
    # restriction is exact while all ice lies inside the cap
    whole = evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg)
    inside = c.tsub.node_mask
    assert bool((c.tice.a_ice[~inside] == 0).all())
    for name in ("u_ice", "v_ice"):
        assert_close(getattr(got, name)[inside],
                     getattr(whole, name)[inside].numpy(), name, tol=1e-12)
    ge = c.tsub.sub_elems.long()
    for name in ("sigma11", "sigma12", "sigma22"):
        assert_close(getattr(got, name)[ge], getattr(whole, name)[ge].numpy(),
                     name, tol=1e-12)


def test_ice_dynamics_raises_for_what_is_not_ported(case):
    c = case
    for which in (0, 2):
        cfg = pi_config()
        cfg.ice.whichEVP = which
        with pytest.raises(NotImplementedError, match="item 17"):
            evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg)
    with pytest.raises(NotImplementedError, match="item 18"):
        evp.ice_dynamics(c.tice, c.tmesh, c.tforcing, c.tsurf, c.cfg,
                         strength_node=c.tice.m_ice)


def emulate_mevp_kernels(uv, sig, tab, mesh):
    """One subcycle as the two kernels run it: mevp_stress element by
    element (its own three vertices, shares written vertex-major), then
    mevp_node node by node (slots in order, padded ones skipped), each
    operation in the kernels' order, in the tables' dtype."""
    e, c = tab.elem_c.numpy(), tab.node_c.numpy()
    T = e.dtype.type
    en = tab.en.numpy()
    uv, sig = uv.numpy().copy(), sig.numpy().copy()
    E, N = e.shape[1], c.shape[1]
    fuv = np.zeros((2, 3, E), e.dtype)
    det1, vale, dmin = T(tab.det1), T(tab.vale), T(tab.delta_min)
    for k in range(E):
        ue, ve = uv[0][en[:, k]], uv[1][en[:, k]]
        dx, dy, mc = e[0:3, k], e[3:6, k], e[6, k]
        eps11 = ((dx[0] * ue[0] + dx[1] * ue[1]) + dx[2] * ue[2]) \
            - ((ve[0] + ve[1]) + ve[2]) * mc
        eps22 = (dy[0] * ve[0] + dy[1] * ve[1]) + dy[2] * ve[2]
        eps12 = T(0.5) * ((((dy[0] * ue[0] + dy[1] * ue[1]) + dy[2] * ue[2])
                           + ((dx[0] * ve[0] + dx[1] * ve[1]) + dx[2] * ve[2]))
                          + ((ue[0] + ue[1]) + ue[2]) * mc)
        eps1, eps2 = eps11 + eps22, eps11 - eps22
        delta = np.sqrt(eps1 * eps1 + vale * (eps2 * eps2
                                              + T(4.0) * (eps12 * eps12)))
        p = e[7, k] / (delta + dmin)
        s11, s12, s22 = sig[:, k]
        if e[9, k] > 0:
            s12n = det1 * s12 + (p * eps12) * vale
            s11n = det1 * s11 + (T(0.5) * p) * ((eps1 - delta) + eps2 * vale)
            s22n = det1 * s22 + (T(0.5) * p) * ((eps1 - delta) - eps2 * vale)
            s11, s12, s22 = s11n, s12n, s22n
        sig[:, k] = s11, s12, s22
        for j in range(3):
            fuv[0, j, k] = -e[8, k] * (s11 * dx[j] + s12 * (dy[j] + mc))
            fuv[1, j, k] = -e[8, k] * ((s12 * dx[j] + s22 * dy[j]) - s11 * mc)
    f = walk_slots(fuv.reshape(2, -1), mesh.nod_in_elem.numpy(),
                   mesh.nod_in_elem_slot.numpy(), E, True)
    rdt, rdt_cd, beta = T(tab.rdt), T(tab.rdt_cd), T(tab.beta)
    rho0, one_beta = T(1030.0), T(1.0 + tab.beta)
    out = uv.copy()
    for n in range(N):
        u, v = uv[0, n], uv[1, n]
        u0, v0, uw, vw, mass, ra, rm, ith, sx, sy, bc, rc, has = c[:, n]
        u_rhs, v_rhs = f[0, n] * mass + ra, f[1, n] * mass + rm
        du, dv = u - uw, v - vw
        drag = ((rdt_cd * np.sqrt(du * du + dv * dv)) * rho0) * ith
        rhsu = ((u0 + drag * uw) + rdt * (ith * sx + u_rhs)) + beta * u
        rhsv = ((v0 + drag * vw) + rdt * (ith * sy + v_rhs)) + beta * v
        a = one_beta + drag
        det = bc / (a * a + rc * rc)
        un, vn = det * (a * rhsu + rc * rhsv), det * (a * rhsv - rc * rhsu)
        if not has > 0:
            un, vn = u, v
        out[:, n] = un * bc, vn * bc
    return out, sig


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mevp_kernel_data_flow_equals_the_plain_subcycle(case, dtype):
    """Three subcycles on the subdomain's tables, emulation against
    ``mevp_subcycle_plain``, bit for bit, in both dtypes: the kernels' order
    of operations is the plain version's."""
    c = case
    cast = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dtype)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).is_floating_point()})
    sub = cast(c.tsub)
    gn, ge = sub.sub_nodes.long(), sub.sub_elems.long()
    pick = lambda obj, idx, names: dataclasses.replace(obj, **{
        k: getattr(obj, k)[idx] for k in names})
    ice = pick(pick(cast(c.tice), gn, ("u_ice", "v_ice", "m_ice", "a_ice",
                                       "m_snow")),
               ge, ("sigma11", "sigma12", "sigma22"))
    forcing = pick(cast(c.tforcing), gn, ("stress_atmice_x",
                                          "stress_atmice_y"))
    surf = pick(cast(c.tsurf), gn, ("u_w", "v_w", "elevation"))
    tab = evp.mevp_setup(ice, sub, forcing, surf, c.cfg)
    assert tab.fuv is None and tab.node_c.dtype == dtype
    assert 0 < int(tab.node_c[12].sum()) < sub.n_nodes
    assert 0 < int(tab.elem_c[9].sum()) <= sub.n_elems
    uv = torch.stack([ice.u_ice, ice.v_ice])
    sig = torch.stack([ice.sigma11, ice.sigma12, ice.sigma22])
    with np.errstate(all="ignore"):
        for _ in range(3):
            want_uv, want_sig = evp.mevp_subcycle_plain(uv, sig, tab, sub)
            got_uv, got_sig = emulate_mevp_kernels(uv, sig, tab, sub)
            assert np.array_equal(got_sig, want_sig.numpy())
            assert np.array_equal(got_uv, want_uv.numpy())
            uv, sig = want_uv, want_sig
    assert float(uv.abs().max()) > 1e-3


def test_mevp_subcycle_work_counts_both_kernels():
    w = evp.mevp_subcycle_work(1000, 1900, 7, 8)
    assert set(w) == {"mevp_stress", "mevp_node"}
    assert w["mevp_stress"][0] == (2 * 1000 + 22 * 1900) * 8 + 3 * 1900 * 4
    assert w["mevp_node"][0] == (6 * 1900 + 17 * 1000) * 8 + 2 * 1000 * 7 * 4


# --------------------------------------------------------------------------
# FCT advection
# --------------------------------------------------------------------------
def ice_fields(ice):
    return [ice.m_ice, ice.a_ice, ice.m_snow]


def test_mass_matvec(case):
    c = case
    want = jax.jit(lambda x: jfct._mass_matvec(x, c.jmesh))(
        jnp.stack(ice_fields(c.jice)))
    got = fct._mass_matvec(torch.stack(ice_fields(c.tice)), c.tmesh)
    assert_close(got, want, "mass_matvec")


def test_ice_tg_rhs_div(case):
    c = case
    dt = c.cfg.dt
    want = jax.jit(lambda i: jfct.ice_tg_rhs_div(
        i.u_ice, i.v_ice, jnp.stack(ice_fields(i)), c.jmesh, dt))(c.jice)
    got = fct.ice_tg_rhs_div(c.tice.u_ice, c.tice.v_ice,
                             torch.stack(ice_fields(c.tice)), c.tmesh, dt)
    for name, a, b in zip(("rhs", "rhs_div"), got, want):
        assert_close(a, b, name)
        assert float(a.abs().max()) > 0.0


def test_fct_advect_fields(case):
    c = case
    dt = c.cfg.dt
    want = jax.jit(lambda i: jfct.fct_advect_fields(
        i.u_ice, i.v_ice, jnp.stack(ice_fields(i)), c.jmesh, 0.5, dt))(c.jice)
    got = fct.fct_advect_fields(c.tice.u_ice, c.tice.v_ice,
                                torch.stack(ice_fields(c.tice)), c.tmesh,
                                0.5, dt)
    assert_close(got, want, "fct_advect_fields")
    assert float((got - torch.stack(ice_fields(c.tice))).abs().max()) > 1e-6


def test_ice_fct_advect(case):
    c = case
    want = jax.jit(lambda i: jfct.ice_fct_advect(i, c.jmesh, c.cfg,
                                                 c.cfg.dt))(c.jice)
    got = fct.ice_fct_advect(c.tice, c.tmesh, c.cfg, c.cfg.dt)
    assert_ice_close(got, want)
    assert float(got.a_ice.max()) <= 1.0


# --------------------------------------------------------------------------
# the ice step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("on_subdomain", [False, True])
def test_ice_timestep(case, on_subdomain):
    c = case
    cfg = subcycle_config(8)
    jsub, tsub = (c.jsub, c.tsub) if on_subdomain else (None, None)
    want = jax.jit(lambda i, f, s: jstep.ice_timestep(
        i, c.jmesh, f, s, cfg, False, ref_sss=34.0, ref_sss_local=True,
        sub=jsub))(c.jice, c.jforcing, c.jsurf)
    got = ice_timestep(c.tice, c.tmesh, c.tforcing, c.tsurf, cfg, False,
                       ref_sss=34.0, ref_sss_local=True, sub=tsub)
    assert_ice_close(got, want)
    assert float(got.u_ice.abs().max()) > 1e-3
    assert float(got.net_heat_flux.abs().max()) > 0.0
