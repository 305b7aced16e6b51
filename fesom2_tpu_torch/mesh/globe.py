"""A global ocean mesh built in code, in the FESOM ASCII format, with
analytic bathymetry, initial state and surface forcing.

It stands in for the reference's pi mesh (``test/meshes/pi``) and the
CORE2 class meshes of its configurations, which are not part of this
repository.  The construction:

- an icosahedron subdivided ``level`` times (10 * 4**level + 2 vertices:
  642 at level 3, 163,842 at level 7), projected onto the sphere;
- an analytic land mask: caps of ``POLE_CAP_DEG`` around both poles of
  the model grid (the rotation (50, 15, -90) of ``force_rotation`` puts
  them at (-40E, 75N) and (140E, 75S)), an Antarctic continent south of
  68S and three continents of spherical caps (the Americas, Afro-Eurasia,
  Australia), so the basins have coasts and ocean lies poleward of 40
  degrees in both hemispheres;
- land triangles (centroid on land) are removed with the nodes they
  leave; only the largest ocean component connected through edges is
  kept, and every node where ocean triangles touch only at a vertex is
  removed, repeatedly, until none is left (either would make the SSH
  operator singular);
- node depths from the distance to the coast: shelves, slopes, two
  ridges, an abyss, and a trench below the deepest level, so partial
  cells and the level counts vary from column to column;
- triangles CLOCKWISE seen from outside the sphere, decided in 3-D by
  the sign of ((b - a) x (c - a)) . a, so neither the seam at 180E nor
  the rotation can flip it (the order of the FESOM mesh files; with
  counter-clockwise triangles the SSH operator is indefinite);
- nodes numbered along a Hilbert curve over the faces of the cube around
  the sphere (``curve_keys``), triangles by their lowest node, so that
  neighbours in space are mostly neighbours in number and a gather over
  an incidence table finds its values close together in memory (edges
  follow through ``build_edges``, which numbers them by their lower
  node).  ``numbering="subdivision"`` keeps the order in which the
  subdivision appends its midpoints, level behind level, which has no
  such locality: it is the same mesh under a permutation, kept so that
  the gather kernels can be timed on both.

``nod2d.out`` holds geographic longitude and latitude, as FESOM files do
when ``force_rotation`` is on (``mesh/io.py`` rotates them into the model
frame on reading).

The vertical grid is an assumption of this module: the reference pi
levels are not in the repository.  ``stretched_levels`` spaces the levels
from ``dz_top`` at the surface to ``dz_bottom`` at depth, bottom at
``depth``; the default is 48 levels (47 layers) from 10 m to 250 m with
the bottom at 6,000 m.

``globe_fixtures`` gives the initial temperature and salinity and the
surface forcing from a seed: a latitude and depth profile of T/S with
0.01 K of seeded noise; a zonal wind stress of 0.1 N m^-2 as a function
of latitude, given directly as model-frame components; a heat flux
pattern; a water flux with zero area mean; a shortwave pattern.

``shelf_draft`` puts an ice shelf of 250 m draft over the ocean south of
62S, for the cavity configuration.

``globe_atm_fixtures`` gives an atmosphere for the coupled step from a
seed: a few records of wind, air temperature, humidity, radiation, rain
and snow on three time axes of different spacing, and a runoff field, in
place of the NCEP series of the reference's test set, which are not part
of this repository either.

Everything here is numpy; ``write_globe`` writes the files that both
packages' ``build_mesh`` read.
"""
from __future__ import annotations

import os

import numpy as np

from ..constants import rad
from .channel import write_mesh
from .io import RawMesh
from .rotation import rotation_matrix, r2g

POLE_CAP_DEG = 12.0
# (lon, lat, radius) in degrees of the continents' spherical caps
CONTINENT_CAPS = (
    (-100.0, 48.0, 22.0), (-62.0, -15.0, 20.0),                 # Americas
    (20.0, 5.0, 30.0), (30.0, 50.0, 22.0), (90.0, 50.0, 35.0),  # Afro-Eurasia
    (135.0, -25.0, 15.0),                                       # Australia
)
ANTARCTIC_LAT = -68.0
# the ice shelf of ``shelf_draft``: its northern edge (degrees) and draft (m)
SHELF_LAT = -62.0
SHELF_DRAFT = -250.0


def stretched_levels(n_layers: int = 47, dz_top: float = 10.0,
                     dz_bottom: float = 250.0, depth: float = 6000.0):
    """Level depths zbar [n_layers + 1] (0 down to -depth), layer
    thickness dz_k = dz_top + (dz_bottom - dz_top) * (k / (n - 1))**p
    with p found by bisection so the layers add up to ``depth``."""
    k = np.arange(n_layers) / max(n_layers - 1, 1)

    def total(p):
        return (dz_top + (dz_bottom - dz_top) * k ** p).sum()
    lo, hi = 1e-3, 50.0
    if not total(hi) <= depth <= total(lo):
        raise ValueError("no stretching reaches the depth with these "
                         "thicknesses")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if total(mid) > depth else (lo, mid)
    dz = dz_top + (dz_bottom - dz_top) * k ** (0.5 * (lo + hi))
    zbar = np.concatenate([[0.0], -np.cumsum(dz)])
    zbar[-1] = -depth
    return zbar


def icosphere(level: int):
    """Unit vectors [10 * 4**level + 2, 3] and triangles [20 * 4**level, 3]."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                  (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                  (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], float)
    f = np.array([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
                  (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
                  (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
                  (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
                 np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(level):
        V = v.shape[0]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        pairs = np.concatenate([np.stack([a, b], 1), np.stack([b, c], 1),
                                np.stack([c, a], 1)])
        key = pairs.min(1) * V + pairs.max(1)
        ukey, inv = np.unique(key, return_inverse=True)
        mid = v[ukey // V] + v[ukey % V]
        v = np.concatenate([v, mid / np.linalg.norm(mid, axis=1,
                                                    keepdims=True)])
        F = f.shape[0]
        ab, bc, ca = (V + inv[:F], V + inv[F:2 * F], V + inv[2 * F:])
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1),
                            np.stack([ab, bc, ca], 1)])
    return v, f


def _unit(lon_deg, lat_deg):
    lo, la = np.radians(lon_deg), np.radians(lat_deg)
    return np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                     np.sin(la)], -1)


def _lonlat(xyz):
    lon = np.degrees(np.arctan2(xyz[..., 1], xyz[..., 0]))
    lat = np.degrees(np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0)))
    return lon, lat


def model_poles():
    """Geographic unit vectors [2, 3] of the model grid's north and south
    poles under the rotation of ``force_rotation`` (50, 15, -90)."""
    m = rotation_matrix(50.0, 15.0, -90.0)
    glon, glat = r2g(np.zeros(2), np.array([np.pi / 2, -np.pi / 2]), m)
    return _unit(np.degrees(glon), np.degrees(glat))


def is_land(xyz):
    """The analytic land mask at unit vectors [..., 3]."""
    _, lat = _lonlat(xyz)
    land = lat < ANTARCTIC_LAT
    for p in model_poles():
        land |= xyz @ p > np.cos(np.radians(POLE_CAP_DEG))
    for lo, la, r in CONTINENT_CAPS:
        land |= xyz @ _unit(lo, la) > np.cos(np.radians(r))
    return land


def _edge_pairs(tri):
    """Canonical undirected keys [T, 3] of each triangle's sides
    (tri[:, j], tri[:, j + 1])."""
    n = int(tri.max()) + 1
    a = tri
    b = np.roll(tri, -1, axis=1)
    return np.minimum(a, b) * n + np.maximum(a, b)


def _triangle_neighbors(tri):
    """[T, 3] index of the triangle across each side, -1 on the boundary."""
    key = _edge_pairs(tri).ravel()
    order = np.argsort(key, kind="stable")
    ks = key[order]
    nb = np.full(key.shape[0], -1, np.int64)
    same = ks[1:] == ks[:-1]
    i0, i1 = order[:-1][same], order[1:][same]
    nb[i0] = i1 // 3
    nb[i1] = i0 // 3
    return nb.reshape(-1, 3)


def _largest_component(tri):
    """Boolean [T]: the triangles of the largest component connected
    through edges (label propagation with pointer jumping)."""
    nb = _triangle_neighbors(tri)
    lab = np.arange(tri.shape[0])
    while True:
        cand = np.where(nb >= 0, lab[np.clip(nb, 0, None)], lab[:, None])
        new = np.minimum(lab, cand.min(1))
        new = new[new]
        if np.array_equal(new, lab):
            break
        lab = new
    big = np.bincount(lab).argmax()
    return lab == big


def _pinch_nodes(tri, n_nodes):
    """Nodes where the ocean triangles around them form more than one fan
    (they touch only at the vertex): incident triangles minus incident
    interior edges is the number of fans of a node off a full ring."""
    k = np.bincount(tri.ravel(), minlength=n_nodes)
    nb = _triangle_neighbors(tri)
    inner = nb >= 0
    a, b = tri, np.roll(tri, -1, axis=1)
    # each interior edge appears twice (once from each triangle)
    s = (np.bincount(a[inner], minlength=n_nodes)
         + np.bincount(b[inner], minlength=n_nodes)) // 2
    return (k - s) >= 2


def _clockwise(v, tri):
    """Triangles reordered clockwise seen from outside the sphere."""
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    ccw = (np.cross(b - a, c - a) * a).sum(1) > 0
    tri = tri.copy()
    tri[ccw] = tri[ccw][:, [0, 2, 1]]
    return tri


NUMBERINGS = ("curve", "subdivision")
CURVE_ORDER = 14        # the curve resolves 2**14 cells along a cube edge


def _hilbert_index(x, y, order: int):
    """Position along the Hilbert curve of the cells (x, y) of a
    2**order x 2**order grid (int64 arrays)."""
    x, y = x.copy(), y.copy()
    n = 1 << order
    d = np.zeros_like(x)
    s = n >> 1
    while s > 0:
        rx = (x & s) > 0
        ry = (y & s) > 0
        d += s * s * ((3 * rx) ^ ry)
        turn = ~ry & rx
        x, y = np.where(turn, n - 1 - x, x), np.where(turn, n - 1 - y, y)
        x, y = np.where(ry, x, y), np.where(ry, y, x)
        s >>= 1
    return d


def curve_keys(v, order: int = CURVE_ORDER):
    """A key per unit vector [N, 3] under which neighbours in space are
    mostly neighbours in key: the face of the cube around the sphere that
    the vector points at (+x, -x, +y, -y, +z, -z), then the Hilbert index
    of its central projection on that face."""
    axis = np.abs(v).argmax(1)
    rows = np.arange(v.shape[0])
    major = v[rows, axis]
    face = 2 * axis + (major < 0)
    # the two other components over the major one lie in [-1, 1]
    a = v[rows, (axis + 1) % 3] / np.abs(major)
    b = v[rows, (axis + 2) % 3] / np.abs(major)
    n = 1 << order
    cell = lambda t: np.clip(((t + 1.0) * 0.5 * n).astype(np.int64), 0, n - 1)
    return face * n * n + _hilbert_index(cell(a), cell(b), order)


def _renumber_along_curve(v, f):
    """Nodes in the order of their ``curve_keys`` (ties by their old
    number), triangles by their lowest, then middle, then highest node;
    the order of the vertices inside a triangle is kept."""
    order = np.lexsort((np.arange(v.shape[0]), curve_keys(v)))
    new = np.empty_like(order)
    new[order] = np.arange(order.shape[0])
    v, f = v[order], new[f]
    fs = np.sort(f, axis=1)
    return v, f[np.lexsort((fs[:, 2], fs[:, 1], fs[:, 0]))]


def ocean_triangulation(level: int, numbering: str = "curve"):
    """(unit vectors [N, 3], clockwise triangles [E, 3], coast [N] bool)
    of the ocean: one edge-connected component, no vertex-only contact;
    numbered along the curve, or as the subdivision left it."""
    if numbering not in NUMBERINGS:
        raise ValueError(f"numbering {numbering!r}: one of {NUMBERINGS}")
    v, f = icosphere(level)
    cen = v[f].mean(1)
    f = f[~is_land(cen / np.linalg.norm(cen, axis=1, keepdims=True))]
    while True:
        f = f[_largest_component(f)]
        pinch = _pinch_nodes(f, v.shape[0])
        if not pinch.any():
            break
        f = f[~pinch[f].any(1)]
    used = np.zeros(v.shape[0], bool)
    used[f.ravel()] = True
    renum = np.cumsum(used) - 1
    v, f = v[used], renum[f]
    if numbering == "curve":
        v, f = _renumber_along_curve(v, f)
    f = _clockwise(v, f)
    nb = _triangle_neighbors(f)
    coast = np.zeros(v.shape[0], bool)
    side = nb < 0
    coast[f[side]] = True
    coast[np.roll(f, -1, axis=1)[side]] = True
    return v, f, coast


def _hops_from(mask, tri, max_hops: int):
    """Graph distance in edges of every node from the nodes in ``mask``,
    counted up to ``max_hops`` (farther nodes get ``max_hops``)."""
    a = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2]])
    b = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 0]])
    hops = np.where(mask, 0, max_hops)
    for _ in range(max_hops):
        nxt = hops.copy()
        np.minimum.at(nxt, a, hops[b] + 1)
        np.minimum.at(nxt, b, hops[a] + 1)
        if np.array_equal(nxt, hops):
            break
        hops = nxt
    return hops


def bathymetry(v, tri, coast):
    """Positive node depths [N] in metres: a shelf of 90-150 m at the
    coast, a slope over a few hundred km, an abyss of 4,100-5,500 m, two
    ridges rising to about 2,500 m and a trench below 6,000 m."""
    lon, lat = _lonlat(v)
    edge_km = np.linalg.norm(v[tri[:, 0]] - v[tri[:, 1]], axis=1).mean() \
        * 6371.0
    # beyond 1,600 km from the coast the slope has levelled off
    d_km = _hops_from(coast, tri, int(np.ceil(1600.0 / edge_km))) * edge_km
    lo, la = np.radians(lon), np.radians(lat)
    shelf = 120.0 + 30.0 * np.sin(3.0 * lo)
    abyss = 4800.0 + 700.0 * np.sin(2.0 * lo) * np.cos(la)
    ridge_a = -30.0 + 15.0 * np.sin(2.0 * la)             # mid-Atlantic
    ridge_p = -110.0 + 10.0 * np.cos(3.0 * la)            # east Pacific
    for lon_r, h in ((ridge_a, 2300.0), (ridge_p, 1800.0)):
        dl = (lon - lon_r + 180.0) % 360.0 - 180.0
        abyss = abyss - h * np.exp(-(dl * np.cos(la) * 111.0 / 600.0) ** 2)
    trench = _unit(150.0, 30.0)
    abyss = abyss + 2200.0 * np.exp(-((1.0 - v @ trench) / 2e-3))
    ramp = 1.0 - np.exp(-np.maximum(d_km - 150.0, 0.0) / 250.0)
    return shelf + (abyss - shelf) * ramp


def globe_raw_mesh(level: int = 7, n_layers: int = 47,
                   dz_bottom: float = 250.0,
                   numbering: str = "curve") -> RawMesh:
    """The global ocean mesh as a RawMesh in GEOGRAPHIC coordinates (what
    ``io.read_raw_mesh`` returns for ``write_globe``'s files without
    ``force_rotation``)."""
    v, tri, coast = ocean_triangulation(level, numbering)
    lon, lat = _lonlat(v)
    coords_deg = np.stack([lon, lat], axis=1)
    zbar = stretched_levels(n_layers, dz_bottom=dz_bottom)
    return RawMesh(coords_deg=coords_deg, coords=coords_deg * rad,
                   node_flag=coast.astype(np.int32), elem_nodes=tri,
                   zbar=zbar, depth=-bathymetry(v, tri, coast),
                   nlevels_elem=None, nlevels_node=None, edges=None,
                   edge_tri=None, edge2D_in=None)


def shelf_draft(raw: RawMesh, lat_cut: float = SHELF_LAT,
                draft: float = SHELF_DRAFT) -> np.ndarray:
    """An ice shelf over the globe's Antarctic coast: the draft [N] in
    metres, ``draft`` (negative) under every node south of ``lat_cut``
    degrees geographic and 0 elsewhere (the synthetic shelf of
    ``tests/test_cavity.py``, cut further north: the globe's Antarctica is
    land south of 68S).  ``raw`` is the globe's RawMesh, read with or
    without ``force_rotation`` (``coords_deg`` are geographic either
    way)."""
    return np.where(raw.coords_deg[:, 1] < lat_cut, draft, 0.0)


def write_globe(path: str, level: int = 7, shelf: bool = False,
                **options) -> str:
    """Write ``nod2d.out``, ``elem2d.out`` and ``aux3d.out`` (levels, then
    the positive node depths) of ``globe_raw_mesh(level, **options)``
    (``n_layers``, ``dz_bottom``, ``numbering``); with ``shelf`` also
    ``cavity_depth.out``, the draft of ``shelf_draft``, which
    ``build_mesh`` then reads as the mesh's cavities."""
    raw = globe_raw_mesh(level, **options)
    write_mesh(raw, path)
    with open(os.path.join(path, "aux3d.out"), "a") as fh:
        fh.write("\n".join(f"{-d:.17g}" for d in raw.depth) + "\n")
    if shelf:
        with open(os.path.join(path, "cavity_depth.out"), "w") as fh:
            fh.write("\n".join(f"{d:.17g}" for d in shelf_draft(raw)) + "\n")
    return path


def globe_fixtures(geo_lat, elem_nodes, Z, nlevels_node, area, seed: int = 0):
    """Initial T/S and surface forcing as numpy arrays, from the mesh
    tables' geographic node latitude [N] (radians), element nodes [E, 3],
    layer mid depths Z [nl-1], level counts [N] and surface node areas
    [N] (the weights of the zero-mean water flux).

    Returns a dict: ``T``, ``S`` [nl-1, N] (zero below the bottom);
    ``stress_x``, ``stress_y`` [E] (N m^-2, model-frame components);
    ``stress_atm_x``, ``stress_atm_y`` [N]; ``heat_flux`` [N] (W m^-2,
    positive out of the ocean); ``water_flux`` [N] (m s^-1, positive out of
    the ocean, zero area mean); ``shortwave`` [N] (W m^-2)."""
    rng = np.random.default_rng(seed)
    lat = np.asarray(geo_lat, np.float64)
    Z = np.asarray(Z, np.float64)
    L, N = Z.shape[0], lat.shape[0]
    wet = np.arange(L)[:, None] < (np.asarray(nlevels_node)[None, :] - 1)
    c2 = np.cos(lat) ** 2
    T = 1.5 + (26.0 * c2 - 1.5 - 1.0)[None, :] \
        * np.exp(Z[:, None] / 700.0) + 0.01 * rng.standard_normal((L, N))
    S = 34.6 + (0.7 * c2 - 0.2)[None, :] * np.exp(Z[:, None] / 400.0)
    lat_e = lat[np.asarray(elem_nodes)].mean(1)

    def tau(la):
        return -0.1 * np.cos(3.0 * la) * np.where(np.abs(la) < np.pi / 3,
                                                  1.0, np.cos(la) * 2.0)
    wf = 2.0e-8 * (np.cos(4.0 * lat) - 0.3 * np.sin(lat))
    area = np.asarray(area, np.float64)
    wf = wf - (wf * area).sum() / area.sum()
    return dict(
        T=np.where(wet, T, 0.0), S=np.where(wet, S, 0.0),
        stress_x=tau(lat_e), stress_y=np.zeros_like(lat_e),
        stress_atm_x=tau(lat), stress_atm_y=np.zeros_like(lat),
        heat_flux=-90.0 * np.cos(2.0 * lat) + 20.0 * np.sin(lat),
        water_flux=wf,
        shortwave=260.0 * np.clip(np.cos(lat), 0.0, None) ** 1.5)


def recut_columns(nlevels_node, nl: int, zbar, Z, depths: dict):
    """The level counts of a globe with some columns recut, for the column
    kernels' tests: every 37th node from the 5th keeps one wet layer
    (``nlevels - 1 == 1``), every 29th from the 11th reaches the full depth
    (``nlevels - 1 == nl - 1``; the globe leaves its last layer dry) and
    takes the standard depths in place of its partial cell.

    ``depths`` holds a state's ``Z_3d`` [nl-1, N], ``zbar_3d`` [nl, N] and
    ``hnode`` [nl-1, N] as numpy arrays; ``zbar`` [nl] and ``Z`` [nl-1] are
    the standard depths.  Returns (nlevels_node [N], node_layer_mask
    [nl-1, N], the three depth arrays recut)."""
    nlev = np.asarray(nlevels_node).copy()
    nlev[5::37] = 2
    full = np.zeros(nlev.shape, dtype=bool)
    full[11::29] = True
    nlev[full] = nl
    mask = np.arange(nl - 1)[:, None] < (nlev - 1)[None, :]
    zbar, Z = np.asarray(zbar), np.asarray(Z)
    std = {"Z_3d": Z, "zbar_3d": zbar, "hnode": zbar[:-1] - zbar[1:]}
    return nlev, mask, {k: np.where(full[None, :], v[:, None],
                                    np.asarray(depths[k]))
                        for k, v in std.items()}


def globe_atm_fixtures(geo_lat, seed: int = 0, n_records: int = 4) -> dict:
    """A code-built atmosphere as numpy arrays, from the geographic node
    latitudes [N] (radians): the fields of ``forcing.atmos.AtmData`` by
    name, each series smooth in latitude plus seeded noise that differs
    from record to record.

    ``n_records`` (at least 3) records on each of three time axes that
    start at 0 s: ``t_wind`` every 6 hours (wind in the model frame, m/s;
    air temperature in Celsius, below freezing poleward of about 60
    degrees; specific humidity at 80 % of saturation), ``t_rad`` daily
    (downward short- and longwave, W m^-2) and ``t_prec`` every 30 days
    (rain and snow, m/s of water; snow where the air is below freezing);
    ``runoff`` [N] is constant in time."""
    if n_records < 3:
        raise ValueError("n_records must be at least 3")
    rng = np.random.default_rng(seed)
    lat = np.asarray(geo_lat, np.float64)
    N, T = lat.shape[0], n_records
    c = np.clip(np.cos(lat), 0.0, None)
    noise = lambda scale: scale * rng.standard_normal((T, N))
    swing = (1.0 + 0.1 * np.cos(np.arange(T)))[:, None]    # record to record
    u_wind = 7.0 * np.cos(3.0 * lat)[None, :] * swing + noise(0.5)
    v_wind = 2.0 * np.sin(2.0 * lat)[None, :] * swing + noise(0.5)
    tair = (30.0 * c ** 1.5 - 10.6 - 12.0 * np.sin(lat) ** 8)[None, :] \
        - 1.0 + swing + noise(0.2)
    shum = 0.8 * 3.8e-3 * np.exp(17.27 * tair / (tair + 237.3))
    swdn = 300.0 * (c ** 1.5)[None, :] * swing + np.abs(noise(2.0))
    lwdn = (220.0 + 130.0 * c ** 2)[None, :] * swing + noise(2.0)
    prec = 1.0e-8 * (0.5 + c ** 2)[None, :] * swing + np.abs(noise(1.0e-10))
    cold = (30.0 * c ** 1.5 - 10.6 < 0.0)[None, :]
    snow = np.where(cold, 0.5 * prec, 0.0)
    axis = lambda step: step * np.arange(T, dtype=np.float64)
    return dict(u_wind=u_wind, v_wind=v_wind, tair=tair, shum=shum,
                t_wind=axis(21600.0), swdn=swdn, lwdn=lwdn,
                t_rad=axis(86400.0), prec=prec, snow=snow,
                t_prec=axis(30.0 * 86400.0),
                runoff=2.0e-9 * c ** 2 + 1.0e-10)
