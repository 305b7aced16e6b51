"""Time the column kernels (pressure_bv, tridiag_solve, kpp_column) on a
code-built globe.

    python -m fesom2_tpu_torch.scripts.column_kernel_times [--level 7]
        [--batches 5] [--calls 20] [--label NAME] [--mesh-dir DIR]
        [--kernels pressure_bv,tridiag_solve,kpp_column]

On one CUDA card: builds the globe of ``mesh/globe.py`` at ``--level``
(7: 114,033 nodes, 225,854 elements, 47 layers, partial cells), puts the
globe's T/S fixtures and seeded velocities on it, then for float64 and
float32 times

- ``eos.pressure_bv`` (JM) on [47, N];
- ``ops.tridiag_solve`` at the three shapes of the coupled step: a, b, c
  [47, N] with d [2, 47, N] (implicit vertical diffusion and advection of
  the two tracers), [47, E] with [2, 47, E] (the momentum solve of u and
  v) and [48, N] with [2, 48, N] (the GM streamfunction); diagonally
  dominant rows, identity rows below each column's bottom;
- ``kpp.kpp_column`` (double diffusion off and on);

each by CUDA events, ``--calls`` calls between one pair of events, the
median over ``--batches`` such batches (``torch.profiler``'s device times
drift late in a long process; a batch of calls between two events does
not; where the wrapper's host work outlasts the kernel, the batch runs at
the host's rate), and by the profiler's device time of the kernel's own
functions over 10 calls.  Each case is held against its plain version (``tridiag_solve``
bitwise, the others within 1e-12 / 1e-5 of max|plain|) and prints the
SHA-256 of its outputs' bytes, so the outputs of two checkouts can be
compared bit for bit.  One JSON object per case on standard output, then
one with the ptxas resource lines of the three kernels.

It calls only the wrappers, ``mesh.build_mesh`` and the state helpers, so
the same file times another checkout of the package when that checkout
leads ``PYTHONPATH``: run two versions in turns within one job to compare
them on one card, e.g. with the parent unpacked into build/parent,

    S=fesom2_tpu_torch/scripts/column_kernel_times.py
    PYTHONPATH=build/parent python $S --label old
    PYTHONPATH=. python $S --label new
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys

import numpy as np
import torch

if __package__:
    from . import timing
else:                   # run as a file, another checkout leading PYTHONPATH
    import timing


def fields_of(state) -> tuple:
    """pressure_bv's outputs in a state (one call, five fields)."""
    return tuple(getattr(state, k) for k in (
        "density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2"))


def globe_state(path, dtype, dev, rng):
    """The globe at ``path`` on the card with its T/S fixtures and node
    velocities drawn from ``rng``: (mesh, state, reference density,
    fixtures, pi configuration)."""
    from fesom2_tpu_torch.core import eos
    from fesom2_tpu_torch.core.state import (allocate_state, initial_z3d,
                                             init_thickness_linfs)
    from fesom2_tpu_torch.mesh import build_mesh, globe
    from fesom2_tpu_torch.model import pi_config
    mesh = build_mesh(path, force_rotation=True, cyclic_length_deg=360.0,
                      use_partial_cell=True, dtype=dtype, device=dev)
    put = lambda a: torch.as_tensor(a, device=dev).to(dtype)
    fx = globe.globe_fixtures(*(x.cpu().numpy() for x in (
        mesh.geo_coords[:, 1], mesh.elem_nodes, mesh.Z,
        mesh.nlevels_node, mesh.area[0])))
    wet = mesh.node_layer_mask
    st = init_thickness_linfs(allocate_state(mesh, 2, dtype), mesh)
    st = dataclasses.replace(
        st, tr=put(np.stack([fx["T"], fx["S"]])),
        unode=put(rng.uniform(-0.3, 0.3, wet.shape)) * wet,
        vnode=put(rng.uniform(-0.3, 0.3, wet.shape)) * wet)
    dref = eos.reference_density(mesh, initial_z3d(mesh, dtype)[1], 1)
    return mesh, st, dref, fx, pi_config()


def kpp_inputs(mesh, st, dref, fx, cfg, dd: bool) -> tuple:
    """kpp_column's arguments on that state after pressure_bv_plain, with
    the fixtures' surface forcing, double diffusion ``dd``."""
    from fesom2_tpu_torch.core import eos
    from fesom2_tpu_torch.core.mixing import kpp
    from fesom2_tpu_torch.core.state import zero_forcing
    dtype, dev = st.tr.dtype, st.tr.device
    stp = eos.pressure_bv_plain(st, mesh, cfg, dref)
    frc = dataclasses.replace(zero_forcing(mesh, dtype), **{
        k: torch.as_tensor(fx[k], device=dev).to(dtype)
        for k in ("stress_x", "stress_y", "heat_flux", "water_flux")})
    kcfg = copy.deepcopy(cfg)
    kcfg.tra.double_diffusion = dd
    return kpp.column_inputs(stp, mesh, kcfg, frc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--label", default="")
    ap.add_argument("--mesh-dir", default="build/column_kernel_times/globe")
    ap.add_argument("--kernels", default="pressure_bv,tridiag_solve,kpp_column",
                    help="comma-separated: the kernels to time")
    args = ap.parse_args(argv)
    only = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("column_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import eos, ops
    from fesom2_tpu_torch.core.mixing import kpp
    from fesom2_tpu_torch.kernels import build
    from fesom2_tpu_torch.mesh import globe

    card = timing.card_name()
    dev = torch.device("cuda", 0)
    path = globe.write_globe(f"{args.mesh_dir}_l{args.level}",
                             level=args.level)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        rng = np.random.default_rng(7)
        mesh, st, dref, fx, cfg = globe_state(path, dtype, dev, rng)
        L, N, E = mesh.nl - 1, mesh.n_nodes, mesh.n_elems
        size = torch.empty((), dtype=dtype).element_size()
        put = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        n_wet = int(mesh.node_layer_mask.sum())
        Case = timing.Case
        tag = str(dtype).replace("torch.", "")
        cases = [Case(lambda: fields_of(eos.pressure_bv(st, mesh, cfg, dref)),
                      lambda: fields_of(eos.pressure_bv_plain(st, mesh, cfg,
                                                              dref)), False,
                      {"kernel": "pressure_bv", "case": f"JM {[L, N]}"},
                      eos.pressure_bv_work(L, N, n_wet, 1, size))]
        for rows, X, nlev in ((L, N, mesh.nlevels_node),
                              (L, E, mesh.nlevels_elem),
                              (L + 1, N, mesh.nlevels_node)):
            active = torch.arange(rows, device=dev)[:, None] \
                < (nlev - 1)[None, :]
            a = torch.where(active, put(rng.uniform(-0.4, 0.0, (rows, X))),
                            0.0)
            c = torch.where(active, put(rng.uniform(-0.4, 0.0, (rows, X))),
                            0.0)
            b = torch.where(active, put(rng.uniform(1.0, 2.0, (rows, X))),
                            1.0)
            d = torch.where(active, put(rng.uniform(-1, 1, (2, rows, X))),
                            0.0)
            cases.append(Case(
                lambda a=a, b=b, c=c, d=d: ops.tridiag_solve(a, b, c, d),
                lambda a=a, b=b, c=c, d=d: ops.tridiag_solve_plain(a, b, c, d),
                True, {"kernel": "tridiag_solve",
                       "case": f"a,b,c {[rows, X]} d {[2, rows, X]}"},
                ops.tridiag_solve_work(2, rows, X, size)))
        for dd in (False, True):
            kargs = kpp_inputs(mesh, st, dref, fx, cfg, dd)
            cases.append(Case(
                lambda a=kargs: kpp.kpp_column(*a),
                lambda a=kargs: kpp.kpp_column_plain(*a), False,
                {"kernel": "kpp_column", "case": f"dd={dd} {[L + 1, N]}"},
                kpp.kpp_column_work(mesh.nl, N, n_wet, dd, size)))

        def timings(c, dtype=dtype):
            b_ms, bound_by = kernels.bound_ms(c.work, dtype)
            name = c.fields["kernel"]
            return {"kernel_us": timing.batch_ms(c.kern, args.calls,
                                                 args.batches) * 1e3,
                    "device_us": sum(
                        us for key, us in timing.device_kernels_us(
                            c.kern).items() if name in key),
                    "plain_us": timing.batch_ms(c.plain, 2, 2) * 1e3,
                    "bound_us": b_ms * 1e3, "bound_by": bound_by}
        cases = [c for c in cases if c.fields["kernel"] in only]
        if not timing.run_cases(cases, tol, timings, label=args.label,
                                card=card, dtype=tag):
            return 1
    print(json.dumps({"label": args.label, "ptxas": ptxas_lines(
        build.library_path().with_suffix(".log"), sorted(only))}))
    return 0


def ptxas_lines(log, names) -> list:
    """The ptxas lines (registers, shared memory, stack and spills) of the
    kernels whose mangled names hold one of ``names``, from a build log."""
    out, keep = [], False
    for ln in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in ln or "Function properties" in ln:
            keep = any(k in ln for k in names)
        if keep and (ln.startswith("ptxas") or "spill" in ln):
            out.append(ln.strip())
    return out


if __name__ == "__main__":
    sys.exit(main())
