"""elem_contrib_to_nodes, the FEM node assembly of the sea ice, as its kernel
walks the packed slot table, and the ice's stacked calls of it; torch only,
on the level-3 globe (12 layers) and its |lat| > 40 ice subdomain.

On the CPU:

* ``elem_slot`` (``mesh/cluster.py``: ``e * 3 + s``, -1 padded) decodes back
  to ``nod_in_elem`` and ``nod_in_elem_slot`` on both tables, and a table
  that names an element or vertex outside the mesh is refused;
* ``cluster.assembly_emulation`` (the kernel's data flow: the slot words
  read once, the rows in runs, two at a time, every gather before the
  first sum) equals ``elem_contrib_to_nodes_plain`` bit for bit in float64
  and float32, both layouts, runs of 1, 2, 3 and all 9 rows;
* ``mevp_setup``'s one call and ``fct_advect_fields``' five equal the
  separate calls of the earlier sequence (kept here) bit for bit, and an
  ice step assembles in six calls of the coupled step's shapes;
* every kernel entry's C signature in ``csrc/`` equals its argument list
  in ``kernels._ARGTYPES``, and the wrapper passes what the kernel takes.

On the card (``cuda`` marker; skips without one): the kernel bit for bit
against the plain version at the coupled step's six shapes on the level-7
globe and its subdomain, float64 and float32, and on tables widened to
K = 7 and 9 (the register and loop forms), where a word past the
contributions gives NaN.  It imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ecn_kernel.py
"""
import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fesom2_tpu_torch import kernels
from fesom2_tpu_torch.constants import g
from fesom2_tpu_torch.core import ops
from fesom2_tpu_torch.ice import evp, fct
from fesom2_tpu_torch.ice.state import (OceanSurface, allocate_ice,
                                        zero_ice_forcing)
from fesom2_tpu_torch.ice.step import ice_timestep
from fesom2_tpu_torch.ice.subdomain import build_ice_subdomain
from fesom2_tpu_torch.mesh import build_mesh, cluster, globe
from fesom2_tpu_torch.model import pi_config

MESH = dict(force_rotation=True, cyclic_length_deg=360.0,
            use_partial_cell=True)
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def globe_tables(path, device, dtype=torch.float64):
    mesh = build_mesh(path, device=device, dtype=dtype, **MESH)
    return {"globe": mesh, "subdomain": build_ice_subdomain(mesh, 40.0)}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    torch.set_num_threads(1)
    return globe_tables(globe.write_globe(
        str(tmp_path_factory.mktemp("globe")), level=3, n_layers=12,
        dz_bottom=1000.0), "cpu")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    itype = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(itype), b.view(itype))


# --------------------------------------------------------------------------
# the packed slot table
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["globe", "subdomain"])
def test_elem_slot_decodes_to_the_incidence_tables(tables, which):
    t = tables[which]
    word = ops.elem_slot_of(t).numpy().T                  # [N, K]
    nie, vert = t.nod_in_elem.numpy(), t.nod_in_elem_slot.numpy()
    used = nie >= 0
    assert word.shape == nie.shape and word.dtype == np.int32
    assert (~used).any() and used.all(1).any()            # padding, and none
    assert np.array_equal(np.where(word >= 0, word // 3, -1), nie)
    assert np.array_equal(word[used] % 3, vert[used])
    assert (word[~used] == -1).all()
    assert ops.elem_slot_of(t).is_contiguous()


def test_elem_slot_table_refuses_what_the_kernel_cannot_read(tables):
    t = tables["subdomain"]
    nie, vert = t.nod_in_elem.numpy(), t.nod_in_elem_slot.numpy()
    E = t.n_elems
    assert np.array_equal(cluster.elem_slot_table(nie, vert, E),
                          t.elem_slot.numpy())
    with pytest.raises(ValueError, match="outside"):
        cluster.elem_slot_table(nie, vert, int(nie.max()))
    bad = vert.copy()
    bad[nie >= 0] = np.where(np.arange((nie >= 0).sum()) == 7, 3,
                             bad[nie >= 0])
    with pytest.raises(ValueError, match="outside"):
        cluster.elem_slot_table(nie, bad, E)
    with pytest.raises(ValueError, match="int32"):
        cluster.elem_slot_table(nie, vert, 1 << 30)


# --------------------------------------------------------------------------
# the kernel's data flow
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vertex_major", [False, True])
@pytest.mark.parametrize("which", ["globe", "subdomain"])
def test_assembly_emulation_is_the_plain_slot_order_sum(tables, dtype,
                                                        vertex_major, which):
    t = tables[which]
    E, R = t.n_elems, 9
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal(
        (R, 3, E) if vertex_major else (R, E, 3))).to(dtype)
    want = ops.elem_contrib_to_nodes_plain(x, t, vertex_major)
    for chunk in (1, 2, 3, R):
        got = cluster.assembly_emulation(x.reshape(R, -1), ops.elem_slot_of(t),
                                         E, vertex_major, chunk)
        assert same_bits(got, want), chunk


def test_assembly_row_chunk_aims_at_the_target_blocks():
    # the level-7 globe: 446 blocks of 256 nodes a run of rows; the
    # fewest rows a thread whose runs stay within the runs wanted
    for rows in (1, 2, 3, 6, 9):
        wanted = min(rows, -(-cluster.ASSEMBLY_TARGET_BLOCKS // 446))
        chunk = cluster.assembly_row_chunk(rows, 446)
        assert 1 <= chunk <= rows and -(-rows // chunk) <= wanted
        assert chunk == 1 or -(-rows // (chunk - 1)) > wanted
    # a small mesh: a row a thread; a mesh past the target: all rows
    assert cluster.assembly_row_chunk(9, 1) == 1
    assert cluster.assembly_row_chunk(9, 10 ** 6) == 9
    assert cluster.row_chunk(94, 446) == cluster.row_chunk(
        94, 446, cluster.ROW_TARGET_BLOCKS)


# --------------------------------------------------------------------------
# the stacked calls of the sea ice
# --------------------------------------------------------------------------
def seeded_ice(mesh, seed=11):
    """An ice state with ice poleward of 55 degrees, its forcing and an
    ocean surface, from a seed."""
    rng = np.random.default_rng(seed)
    N, E = mesh.n_nodes, mesh.n_elems
    polar = torch.tensor(np.abs(np.degrees(
        mesh.geo_coords[:, 1].numpy())) > 55.0)
    u = lambda lo, hi, n=N: torch.tensor(rng.uniform(lo, hi, n))
    ice = dataclasses.replace(
        allocate_ice(mesh, torch.float64),
        u_ice=torch.where(polar, u(-0.1, 0.1), 0.0),
        v_ice=torch.where(polar, u(-0.1, 0.1), 0.0),
        m_ice=torch.where(polar, u(0.3, 2.5), 0.0),
        a_ice=torch.where(polar, u(0.3, 1.0), 0.0),
        m_snow=torch.where(polar, u(0.0, 0.4), 0.0),
        sigma11=u(-200.0, 200.0, E), sigma12=u(-200.0, 200.0, E),
        sigma22=u(-200.0, 200.0, E))
    forcing = dataclasses.replace(
        zero_ice_forcing(mesh, torch.float64),
        stress_atmice_x=u(-0.2, 0.2), stress_atmice_y=u(-0.2, 0.2))
    surf = OceanSurface(T_oc=u(-1.5, 1.0), S_oc=u(33.0, 35.5),
                        u_w=u(-0.05, 0.05), v_w=u(-0.05, 0.05),
                        elevation=u(-0.3, 0.3))
    return ice, forcing, surf


def count_calls(monkeypatch) -> list:
    """Record (shape, vertex_major) of every assembly call from here on."""
    calls, real = [], ops._elem_contrib_to_nodes

    def spy(contrib, mesh, vertex_major):
        calls.append((tuple(contrib.shape), vertex_major))
        return real(contrib, mesh, vertex_major)
    monkeypatch.setattr(ops, "_elem_contrib_to_nodes", spy)
    return calls


def test_mevp_setup_one_call_equals_two(tables, monkeypatch):
    mesh, sub = tables["globe"], tables["subdomain"]
    ice, forcing, surf = seeded_ice(mesh)
    ice, forcing, surf = evp.subdomain_inputs(ice, sub, forcing, surf)
    calls = count_calls(monkeypatch)
    tab = evp.mevp_setup(ice, sub, forcing, surf, pi_config())
    assert calls == [((2, sub.n_elems, 3), False)]
    # the earlier sequence: one one-row call for each component
    en = sub.elem_nodes.long()
    eta_e = surf.elevation[en]
    bb = g * sub.elem_area / 3.0
    aa_e = bb * (sub.gradient_sca[:, 0:3] * eta_e).sum(-1)
    bb_e = bb * (sub.gradient_sca[:, 3:6] * eta_e).sum(-1)
    rhs_a = ops.elem_contrib_to_nodes((-aa_e)[:, None].expand(-1, 3), sub)
    rhs_m = ops.elem_contrib_to_nodes((-bb_e)[:, None].expand(-1, 3), sub)
    area1 = sub.area[0]
    area1s = torch.where(area1 > 0, area1, 1.0)
    has_ice = ice.a_ice >= 0.01
    assert has_ice.any() and float(rhs_a.abs().max()) > 0.0
    for row, rhs in ((5, rhs_a), (6, rhs_m)):
        assert same_bits(tab.node_c[row],
                         torch.where(has_ice, rhs / area1s, 0.0))


def earlier_fct_advect_fields(u_ice, v_ice, fields, mesh, gamma, ice_dt,
                              monkeypatch):
    """``fct.fct_advect_fields`` as the separate calls of the JAX package's
    sequence: the two right-hand sides apart, the high-order iteration,
    the low-order mass product and the divergence iteration each on its
    own (nine assembly calls)."""
    def two_calls(contrib, m):
        F = contrib.shape[0] // 2
        return torch.cat([ops.elem_contrib_to_nodes_3e(contrib[:F], m),
                          ops.elem_contrib_to_nodes_3e(contrib[F:], m)])
    with monkeypatch.context() as mp:
        mp.setattr(fct, "elem_contrib_to_nodes_3e", two_calls)
        rhs, rhs_div = fct.ice_tg_rhs_div(u_ice, v_ice, fields, mesh, ice_dt)
    inv_area = fct._inv_area(mesh)

    def lumped_iterate(r):
        d = r * inv_area
        for _ in range(2):
            resid = r - fct._mass_matvec(d, mesh)
            d = d + resid * inv_area
        return d
    d_high = lumped_iterate(rhs)
    area1 = mesh.area[0]
    low = (rhs + gamma * fct._mass_matvec(fields, mesh)) * inv_area \
        + (1.0 - gamma) * fields
    en = mesh.elem_nodes.long()
    y = gamma * fields + d_high
    ye = y[..., en]
    s = ye.sum(-1)
    flux_q = -(s[..., None] - 3.0 * ye) * mesh.elem_area[:, None] / 12.0
    flux_q = flux_q / torch.clamp_min(area1[en], 1e-30)
    nn = mesh.node_neighbors.long()
    nvalid = nn >= 0
    nb = low[..., torch.where(nvalid, nn, 0)]
    big = torch.finfo(low.dtype).max
    tmax = torch.maximum(low, torch.where(nvalid, nb, -big).amax(-1)) - low
    tmin = torch.minimum(low, torch.where(nvalid, nb, big).amin(-1)) - low
    ppair = ops.elem_contrib_to_nodes(
        torch.stack([flux_q.clamp_min(0.0), flux_q.clamp_max(0.0)]), mesh)
    pplus, pminus = ppair[0], ppair[1]
    pplus = torch.where(
        pplus.abs() > 0,
        torch.clamp_max(tmax / torch.where(pplus != 0, pplus, 1.0), 1.0), 0.0)
    pminus = torch.where(
        pminus.abs() > 0,
        torch.clamp_max(tmin / torch.where(pminus != 0, pminus, 1.0), 1.0),
        0.0)
    fac = torch.where(flux_q >= 0, pplus[..., en], pminus[..., en])
    out = low + ops.elem_contrib_to_nodes(fac.amin(-1)[..., None] * flux_q,
                                          mesh)
    return out + lumped_iterate(rhs_div)


def test_fct_advect_fields_five_calls_equal_nine(tables, monkeypatch):
    mesh = tables["globe"]
    ice = seeded_ice(mesh)[0]
    fields = torch.stack([ice.m_ice, ice.a_ice, ice.m_snow])
    dt = pi_config().dt
    calls = count_calls(monkeypatch)
    want = earlier_fct_advect_fields(ice.u_ice, ice.v_ice, fields, mesh, 0.5,
                                     dt, monkeypatch)
    assert len(calls) == 9
    del calls[:]
    got = fct.fct_advect_fields(ice.u_ice, ice.v_ice, fields, mesh, 0.5, dt)
    E = mesh.n_elems
    assert calls == [((6, 3, E), True), ((9, E, 3), False),
                     ((6, E, 3), False), ((2, 3, E, 3), False),
                     ((3, E, 3), False)]
    assert same_bits(got, want)
    assert float((got - fields).abs().max()) > 1e-6


@pytest.mark.parametrize("on_subdomain", [False, True])
def test_an_ice_step_assembles_in_six_calls(tables, monkeypatch,
                                            on_subdomain):
    mesh, sub = tables["globe"], tables["subdomain"]
    cfg = pi_config()
    cfg.ice.evp_rheol_steps = 2
    ice, forcing, surf = seeded_ice(mesh)
    calls = count_calls(monkeypatch)
    ice_timestep(ice, mesh, forcing, surf, cfg, False,
                 sub=sub if on_subdomain else None)
    tab = sub if on_subdomain else mesh
    E = mesh.n_elems
    assert calls == [((2, tab.n_elems, 3), False), ((6, 3, E), True),
                     ((9, E, 3), False), ((6, E, 3), False),
                     ((2, 3, E, 3), False), ((3, E, 3), False)]


# --------------------------------------------------------------------------
# the bindings
# --------------------------------------------------------------------------
def c_signatures() -> dict:
    """{entry name: [ctypes type, ...]} of every ``extern "C" int fesom_*``
    definition under csrc/: a pointer as c_void_p, an int as c_int, a
    double as c_double."""
    kinds = {"int": ctypes.c_int, "double": ctypes.c_double}
    sigs = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int fesom_(\w+)\(([^)]*)\)\s*\{', src.read_text()):
            sigs[name] = [ctypes.c_void_p if "*" in p
                          else kinds[p.split()[-2]]
                          for p in params.replace("\n", " ").split(",")]
    return sigs


def test_argument_lists_match_the_c_signatures():
    sigs = c_signatures()
    assert set(kernels._ARGTYPES) <= set(sigs)
    for name, argtypes in kernels._ARGTYPES.items():
        assert argtypes == sigs[name], name
    assert sigs["elem_contrib_to_nodes"][3:8] == [
        ctypes.c_void_p] + [ctypes.c_int] * 4


@pytest.mark.parametrize("vertex_major", [False, True])
@pytest.mark.parametrize("which", ["globe", "subdomain"])
def test_wrapper_passes_what_the_kernel_takes(tables, monkeypatch,
                                              vertex_major, which):
    """The launch, recorded on the CPU: the C signature's arguments, the
    packed table, ``assembly_row_chunk`` rows per thread."""
    t = tables[which]
    E, N = t.n_elems, t.n_nodes
    calls = []

    def record(kernel, device, *args, entry=""):
        sig = kernels._ARGTYPES[kernel + entry]
        assert len(args) + 1 == len(sig)
        for a, typ in zip(args, sig):
            if typ is ctypes.c_void_p:
                assert isinstance(a, torch.Tensor) and a.is_contiguous()
            else:
                assert type(a) is int
        calls.append(args)

    monkeypatch.setattr(kernels, "launch", record)
    monkeypatch.setattr(kernels, "cuda_only", lambda x, what: None)
    x = torch.zeros((2, 3, 3, E) if vertex_major else (2, 3, E, 3),
                    dtype=torch.float32)
    assert ops._assemble(x, t, vertex_major).shape == (2, 3, N)
    (args,) = calls
    K = t.nod_in_elem.shape[1]
    assert args[0].shape == (6, 3 * E) and args[3] is ops.elem_slot_of(t)
    assert args[1:3] == (6, E) and args[4:8] == (
        N, K, cluster.assembly_row_chunk(6, -(-N // kernels.BLOCK_THREADS)),
        int(vertex_major))
    assert args[9] == 0
    with pytest.raises(ValueError, match="trailing shape"):
        ops._assemble(x, t, not vertex_major)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")


# the coupled step's calls: (tables, leading rows, vertex-major)
STEP_SHAPES = (("subdomain", (2,), False), ("globe", (6,), True),
               ("globe", (9,), False), ("globe", (6,), False),
               ("globe", (2, 3), False), ("globe", (3,), False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_equals_plain_at_the_coupled_steps_shapes_on_card(
        tmp_path, dtype):
    _need_card()
    t = globe_tables(globe.write_globe(str(tmp_path), level=7), "cuda",
                     dtype)
    rng = np.random.default_rng(17)
    kernels.reset_launches()
    for which, lead, vertex_major in STEP_SHAPES:
        tab = t[which]
        E = tab.n_elems
        x = torch.as_tensor(rng.standard_normal(
            lead + ((3, E) if vertex_major else (E, 3))),
            device="cuda").to(dtype)
        fn = ops.elem_contrib_to_nodes_3e if vertex_major \
            else ops.elem_contrib_to_nodes
        got = fn(x, tab)
        want = ops.elem_contrib_to_nodes_plain(x, tab, vertex_major)
        assert got.shape == lead + (tab.n_nodes,)
        assert same_bits(got, want), (which, lead, vertex_major)
        # and the CPU's plain version, the same adds in the same order
        cpu = ops.elem_contrib_to_nodes_plain(
            x.cpu(), dataclasses.replace(
                tab, nod_in_elem=tab.nod_in_elem.cpu(),
                nod_in_elem_slot=tab.nod_in_elem_slot.cpu()), vertex_major)
        assert same_bits(got.cpu(), cpu)
    assert kernels.LAUNCHES["elem_contrib_to_nodes"] == len(STEP_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_on_wider_tables_on_card(tables, extra, dtype):
    """The subdomain's tables with ``extra`` padded slots in front (K = 7:
    the register form of 8 slots; K = 9: the loop form), then one word
    past the contributions: that node's rows are NaN, the rest unchanged."""
    _need_card()
    sub = tables["subdomain"]
    pad = torch.full((sub.n_nodes, extra), -1, dtype=torch.int32)
    nie = torch.cat([pad, sub.nod_in_elem], 1)
    vert = torch.cat([pad, sub.nod_in_elem_slot], 1)
    wide = dataclasses.replace(
        sub, nod_in_elem=nie.cuda(), nod_in_elem_slot=vert.cuda(),
        elem_slot=torch.as_tensor(cluster.elem_slot_table(
            nie.numpy(), vert.numpy(), sub.n_elems), device="cuda"))
    E = sub.n_elems
    rng = np.random.default_rng(extra)
    for vertex_major, fn in ((False, ops.elem_contrib_to_nodes),
                             (True, ops.elem_contrib_to_nodes_3e)):
        x = torch.as_tensor(rng.standard_normal(
            (5, 3, E) if vertex_major else (5, E, 3)), device="cuda").to(dtype)
        want = ops.elem_contrib_to_nodes_plain(x, wide, vertex_major)
        assert same_bits(fn(x, wide), want)
        broken = wide.elem_slot.clone()
        node = int((broken[extra] >= 0).nonzero()[3])
        broken[extra, node] = 3 * E
        got = fn(x, dataclasses.replace(wide, elem_slot=broken))
        assert got[:, node].isnan().all()
        keep = torch.arange(sub.n_nodes, device="cuda") != node
        assert same_bits(got[:, keep], want[:, keep])
