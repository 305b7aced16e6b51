"""Time ``bl99_temperature_solve`` (K19), ``dens_moc_bin`` (K21) and
``itd_remap`` (K20) against another checkout's kernels, in turns, on the
level-7 inputs that ``chip_smoke.py`` phase 3 holds them on.

    python -m fesom2_tpu_torch.scripts.bl99_dmoc_kernel_times --parent DIR
        [--parent DIR ...] [--kernels bl99,dmoc,itd] [--level 7]
        [--reps 10] [--itd-variants "kWarps=2;kHeld64=1;minBlocks=8"]
        [--out FILE]

Each DIR is a checkout of another commit (``git archive`` of the parent
into a directory that ``.gitignore`` lists) or a copy of this one with
other kernel sources; its kernel library is built from its own sources and
its entry points are called through ctypes with its own argument lists
(the first design's for ``bl99_temperature_solve`` where the library lacks
``fesom_dens_moc_bin_plan``, which came with the second; for ``itd_remap``
where it lacks ``fesom_itd_remap_plan``: the packed state updated in
place).  On one CUDA card, one process.  It prints the card's name and
power limit first, then one JSON object per line (also appended to
``--out``), float64 then float32:

* ``bl99_temperature_solve`` on the Icepack CI step's columns of its second
  coupled step (``ice.icepack.driver.recording_kernel_inputs``), [5, N]:
  this checkout's kernel and each other's against each other (SHA-256 of
  the outputs, bitwise or the largest difference, the sweep counts) and
  against the plain version (the tolerance of phase 3, the sweep count);
  device us hot and with the L2 flushed (a 256 MB overwrite before each
  call), ms by CUDA events of one call and of a call in a batch of 20, in
  turns (new, the others, then backwards);
  the launch plan of each and the registers ``ptxas`` gave each; the
  sweeps' maxima, the chunks this checkout's kernel ran and its sweeps;
* ``dens_moc_bin`` on the interface densities and layers of the CI state
  after one coupled step, [5, S, E]: the same comparisons and turns, its
  plan and the span widths of its inputs;
* ``itd_remap``'s two calls of that Icepack step (the remap with the
  rebin after thermo2, the rebin after ridging), [5, 12, N]: the same
  comparisons (bitwise against the plain version and against every other
  kernel) and turns, each kernel writing into a buffer of its own (the
  first design in place on its packed state), and its plan; with
  ``--itd-variants``, copies of this checkout's ``csrc/itd_remap.cu`` with
  its constants set otherwise (``kWarps``, ``kHeld64``, ``kHeld32``,
  ``kReversed``, or ``minBlocks``: the minimum of resident blocks in
  ``__launch_bounds__``;
  ``;`` between variants, ``,`` between the settings of one), each built
  alone into ``build/itd_variants/``, held and timed in the same turns.

Each row carries the bound of the function's ``*_work`` counter.  Run it
through the card tool, not from ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import inspect
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

try:
    from .timing import (batch_ms, build_source_variant, card_name, digest,
                         events_ms, kernel_us, load_checkout_library,
                         same_bits)
except ImportError:     # run as a file: python .../bl99_dmoc_kernel_times.py
    from timing import (batch_ms, build_source_variant, card_name, digest,
                        events_ms, kernel_us, load_checkout_library,
                        same_bits)

P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
BL99_OUTS = ("Tsf", "Tsn", "Tin", "melting", "fsurf", "fcondtop",
             "fcondbot", "fsens", "flat", "flwout")


def ptxas_registers(lines, names=("bl99_kernel", "dens_moc_bin",
                                   "itd_remap_kernel")) -> dict:
    """{kernel instance: registers, or [registers, stack bytes] where the
    stack is not empty} of the ptxas lines of a build log (a path) or of a
    list of lines."""
    regs, current = {}, None
    if isinstance(lines, Path):
        if not lines.exists():
            return regs
        lines = lines.read_text().splitlines()
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes cumulative "
                      r"stack)?", line)
        if m and current and any(n in current for n in names):
            # the instance's template arguments, demangled by hand
            k = re.search(r"(bl99_kernel|dens_moc_bin_kernel|itd_remap_kernel)"
                          r"I([df])((?:Li\d+E)*)", current)
            targs = ["double" if k.group(2) == "d" else "float"] + \
                re.findall(r"Li(\d+)E", k.group(3))
            stack = int(m.group(2) or 0)
            regs[f"{k.group(1)}<{','.join(targs)}>"] = \
                [int(m.group(1)), stack] if stack else int(m.group(1))
            current = None
    return regs


def models(path: str, dtype):
    """The CI model on the globe at ``path`` and the Icepack CI model on
    its tables (as ``chip_smoke.py`` phase 3 builds them), and the
    atmosphere."""
    from fesom2_tpu_torch.ice.icepack import IcepackConfig
    from fesom2_tpu_torch.model import Model, setup_pi_model
    m, atm = setup_pi_model(path, device="cuda", dtype=dtype)
    cfg = copy.deepcopy(m.cfg)
    cfg.run.use_icepack = True
    cfg.icepack = IcepackConfig()
    mi = Model(m.mesh, cfg, m.tracer_statics, m.density_ref,
               ice_sub=m.ice_sub, ssh_dense_inv=m.ssh_dense_inv,
               ssh_ring=m.ssh_ring, ssh_block_pc=m.ssh_block_pc)
    return m, mi, atm


def icepack_inputs(mi, atm) -> dict:
    """The arguments of the Icepack step's kernel calls in its second
    coupled step (``driver.recording_kernel_inputs``)."""
    from fesom2_tpu_torch.ice.icepack import driver, init_icepack_state
    from fesom2_tpu_torch.model import pi_coupled_step_fn, pi_initial_state
    step = pi_coupled_step_fn(mi, atm)
    st, ice = pi_initial_state(mi)
    ipk = init_icepack_state(mi.cfg.icepack, ice.a_ice, ice.m_ice,
                             ice.m_snow, ice.t_skin, dtype=mi.dtype)
    st, ice, ipk, _ = step(st, ice, 0, ipk)
    with driver.recording_kernel_inputs() as rec:
        step(st, ice, 1, ipk)
    return rec


def bl99_inputs(rec) -> dict:
    """temperature_solve's arguments, by name, from ``icepack_inputs``."""
    from fesom2_tpu_torch.ice.icepack import thermo_vertical as tv
    args, kw = rec["temperature_solve"][0]
    bound = inspect.signature(tv.temperature_solve).bind(*args, **kw)
    bound.apply_defaults()
    return dict(bound.arguments)


def dmoc_inputs(m, atm) -> tuple:
    """dens_moc_bin's arguments on the CI state after one coupled step."""
    from fesom2_tpu_torch.core import diagnostics
    from fesom2_tpu_torch.model import pi_coupled_step_fn, pi_initial_state
    st, ice = pi_initial_state(m)
    st, _, _ = pi_coupled_step_fn(m, atm)(st, ice, 0)
    mesh = m.mesh
    dens = diagnostics.interface_density(st, mesh, m.cfg)
    bins = torch.as_tensor(diagnostics.STD_DENS, device="cuda").to(m.dtype)
    return (dens, st.helem, st.u, st.v, mesh.elem_area, mesh.ulevels_elem,
            mesh.nlevels_elem, bins)


def bl99_entry(lib, a: dict):
    """The bl99_temperature_solve entry of the kernel library ``lib`` (this
    checkout's or another's) on these arguments, called through ctypes with
    its own C signature (the first design's, or this one's with its scratch
    and fallback chunk length ``BL99_CHUNK``): a function returning its
    outputs, the library's plan, and the error slots each call fills (the
    sweeps' maxima, as order-preserving bits)."""
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.ice.icepack import thermo_vertical as tv
    second = hasattr(lib, "fesom_dens_moc_bin_plan")
    fn = lib.fesom_bl99_temperature_solve
    fn.argtypes = kernels._ARGTYPES["bl99_temperature_solve"] if second \
        else [P] * 27 + [I] * 6 + [D] * 3 + [I, P]
    fn.restype = ctypes.c_int
    cfg, hi = a["cfg"], a["hi"]
    ncat, N = hi.shape
    table = tv._layer_table(a["sal"], a["Tmlt"], hi.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    state = torch.empty(2 * (2 + cfg.nilyr) * ncat * N, dtype=hi.dtype,
                        device=hi.device)
    slots = torch.zeros(tv.NIT_MAX, dtype=torch.int64, device=hi.device)

    def call():
        out = dict(Tsf=torch.empty_like(hi), Tsn=torch.empty_like(a["Tsn0"]),
                   Tin=torch.empty_like(a["Tin0"]),
                   melting=torch.empty((ncat, N), dtype=torch.bool,
                                       device=hi.device),
                   **{k: torch.empty_like(hi) for k in BL99_OUTS[4:]},
                   niter=torch.empty((), dtype=torch.int32,
                                     device=hi.device))
        slots.zero_()
        scratch = (state.data_ptr(),) if second else ()
        chunk = (tv.BL99_CHUNK,) if second else ()
        err = fn(*(ptr(a[k]) for k in (
            "hi", "hs", "Tsf0", "Tsn0", "Tin0", "fswsfc", "iabs", "flw",
            "Tair", "shum", "wind", "Tbot", "shcoef", "lhcoef")),
            table.data_ptr(), *(out[k].data_ptr() for k in tv.BL99_OUTPUTS),
            slots.data_ptr(), *scratch, ncat, N, cfg.nilyr, cfg.nslyr,
            cfg.niter_therm, tv.CONDUCT[cfg.conduct], *chunk, float(a["dt"]),
            float(cfg.ksno), float(cfg.emissivity),
            kernels.float_code(hi.dtype),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other bl99_temperature_solve: CUDA error "
                               f"{err}")
        return out
    res = (ctypes.c_int * 4)()
    lib.fesom_bl99_plan.argtypes = [I, I, P]
    lib.fesom_bl99_plan(ncat * N, kernels.float_code(hi.dtype),
                        ctypes.addressof(res))
    return call, dict(grid=res[0], block=res[1]), slots


def dmoc_entry(lib, args):
    """The dens_moc_bin entry of the kernel library ``lib`` on these
    arguments (one C signature in both designs)."""
    from fesom2_tpu_torch import kernels
    fn = lib.fesom_dens_moc_bin
    fn.argtypes = kernels._ARGTYPES["dens_moc_bin"]
    fn.restype = ctypes.c_int
    dens, *_, bins = args
    nl, E = dens.shape
    S = bins.shape[0]

    def call(fer=(None, None)):
        out = torch.empty((5, S, E), dtype=dens.dtype, device=dens.device)
        ptrs = [t.data_ptr() for t in args[:4]] + [
            None if t is None else t.data_ptr() for t in fer] + [
            t.data_ptr() for t in args[4:]]
        err = fn(*ptrs, out.data_ptr(), nl, E, S,
                 kernels.float_code(dens.dtype),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other dens_moc_bin: CUDA error {err}")
        return out
    return call


def itd_entry(lib, args):
    """The itd_remap entry of the kernel library ``lib`` on the recorded
    arguments (the eight category tensors, aicen_init, vicen_init, hin_max,
    linear): this design's (the tensors where they lie, into a pack of its
    own; the library has ``fesom_itd_remap_plan``) or the first (the packed
    state updated in place, on a buffer of its own).  Returns a function
    giving a copy of the pack of one call on these inputs, and one that
    launches the kernel alone (the first design: on its buffer again)."""
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.ice.icepack import itd
    cats, (a0, v0, hin_max, linear) = args[:8], args[8:]
    ncat, n = cats[0].shape
    counts = [t.shape[1] for t in cats[4:]]
    code = kernels.float_code(cats[0].dtype)
    hb = itd._bounds_on(hin_max, cats[0].device)
    init = (a0.data_ptr(), v0.data_ptr()) if linear else (None, None)
    pack = itd.pack_itd(*cats)
    fn = lib.fesom_itd_remap
    fn.restype = ctypes.c_int
    if hasattr(lib, "fesom_itd_remap_plan"):
        fn.argtypes = kernels._ARGTYPES["itd_remap"]
        buf = torch.empty_like(pack)
        ptrs = [t.data_ptr() for t in cats]
        cargs = lambda: (*ptrs, buf.data_ptr(), *init, hb.data_ptr(), ncat,
                         n, *counts, int(linear), code)
        fresh = lambda: None
    else:
        fn.argtypes = [P] * 4 + [I] * 8 + [P]
        buf = pack.clone()
        cargs = lambda: (buf.data_ptr(), *init, hb.data_ptr(), ncat,
                         pack.shape[1], n, *counts[:3], int(linear), code)
        fresh = lambda: buf.copy_(pack)

    def launch():
        err = fn(*cargs(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"itd_remap of {lib._name}: CUDA error {err}")
        return buf

    def call():
        fresh()
        return launch().clone()
    return call, launch


# Parts of csrc/itd_remap.cu that a ``cut=NAME`` variant leaves out, to
# see what each costs (its outputs differ: it is timed, not held): the row
# warps' mixes, or every division (a product in its place).
ITD_CUTS = {
    "apply": [("      if (used[h])\n        val[h][cm] = mix(",
               "      if (false)\n        val[h][cm] = mix(")],
    "div": [("    const T d = (need ? num : T(1)) / (need ? den : T(1));",
             "    const T d = (need ? num : T(1)) * (need ? den : T(1));")],
}


def itd_variants(spec: str) -> dict:
    """{name: [(old, new) line of csrc/itd_remap.cu]} of ``--itd-variants``:
    variants split by ``;``, the settings of one by ``,``: ``kWarps=N``,
    ``kHeld64=N``, ``kHeld32=N``, ``kReversed=N`` set that constant,
    ``minBlocks=N`` asks
    ``__launch_bounds__`` for N resident blocks an SM, ``cut=NAME`` leaves
    out a part (``ITD_CUTS``; put it first, and the variant's name starts
    with cut)."""
    from fesom2_tpu_torch.kernels import build
    src = (build.SRC_DIR / "itd_remap.cu").read_text()
    out = {}
    for variant in filter(None, spec.split(";")):
        reps = []
        for setting in variant.split(","):
            key, value = setting.split("=")
            if key == "cut":
                reps += ITD_CUTS[value]
                continue
            if key == "minBlocks":
                reps.append(("__launch_bounds__(kWarps * 32)\n",
                             f"__launch_bounds__(kWarps * 32, {value})\n"))
                continue
            line = re.search(rf"constexpr int {key} = \d+;", src).group(0)
            reps.append((line, f"constexpr int {key} = {value};"))
        out[variant.replace("=", "").replace(",", "_")] = reps
    return out


def compare(got: tuple, want: tuple) -> dict:
    """Bitwise, or the largest difference over the outputs; SHA-256 of
    each side."""
    bitwise = all(same_bits(g, w) for g, w in zip(got, want))
    diff = 0.0 if bitwise else max(
        float((g.double() - w.double()).abs().nan_to_num().max())
        for g, w in zip(got, want))
    return dict(bitwise=bitwise, max_abs_diff=diff, sha256=digest(got),
                sha256_other=digest(want))


def turns(calls: dict, name: str, reps: int, flush) -> dict:
    """Device us hot and flushed (profiler), ms by CUDA events of one call
    and a call's ms over a batch of 20 between two events (the median of
    3 batches: the device's time, as a call outlasts its enqueue), of each
    call, in turns (each in the order given, then backwards)."""
    order = list(calls) + list(calls)[::-1]
    times = {k: [] for k in calls}
    for k in order:
        f = calls[k]
        times[k].append({
            "device_us": kernel_us(f, name, calls=5),
            "cold_device_us": kernel_us(f, name, calls=5, flush=flush),
            "events_ms": events_ms(f, reps=reps, warmup=2),
            "batch_ms": batch_ms(f, calls=20, batches=3)})
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", action="append", default=[])
    ap.add_argument("--kernels", default="bl99,dmoc,itd")
    ap.add_argument("--itd-variants", default="")
    ap.add_argument("--level", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--mesh-dir", default="build/bl99_dmoc_kernel_times/globe")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bl99_dmoc_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    card = card_name()
    print(card, flush=True)
    sink = open(args.out, "a") if args.out else None

    def emit(**row):
        line = json.dumps({"card": card, **row})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.kernels import build
    from fesom2_tpu_torch.mesh import globe

    kernels.library()
    # the other checkouts, by their directories' names
    others = {Path(d).name: load_checkout_library(d) for d in args.parent}
    which = args.kernels.split(",")
    # copies of this checkout's itd_remap with other constants
    specs = itd_variants(args.itd_variants)
    out_dir = Path("build/itd_variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max(len(specs), 1)) as pool:
        built = dict(zip(specs, pool.map(
            lambda v: build_source_variant("itd_remap.cu", v, specs[v],
                                           out_dir), specs)))
    variants = {v: ctypes.CDLL(str(lib)) for v, (lib, _) in built.items()}
    emit(kind="registers", new=ptxas_registers(
        build.library_path().with_suffix(".log")),
         **{name: ptxas_registers(Path(lib._name).with_suffix(".log"))
            for name, lib in others.items()},
         **{v: ptxas_registers(lines) for v, (_, lines) in built.items()})
    path = globe.write_globe(f"{args.mesh_dir}_l{args.level}",
                             level=args.level)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    failed = False
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        size = torch.empty((), dtype=dtype).element_size()
        m, mi, atm = models(path, dtype)

        rec = icepack_inputs(mi, atm) if {"bl99", "itd"} & set(which) \
            else None

        # K19 ---------------------------------------------------------
        if "bl99" in which:
            failed |= time_bl99(bl99_inputs(rec), others, dtype, tag, tol,
                                size, args.reps, flush, emit)

        # K20 ---------------------------------------------------------
        if "itd" in which:
            failed |= time_itd(rec["itd_remap"], {**others, **variants},
                               dtype, tag, size, args.reps, flush, emit)
        del rec

        # K21 ---------------------------------------------------------
        if "dmoc" in which:
            failed |= time_dmoc(dmoc_inputs(m, atm), others, dtype, tag, tol,
                                size, args.reps, flush, emit)
        del m, mi, atm
        torch.cuda.empty_cache()
    return 1 if failed else 0


def time_bl99(a, others, dtype, tag, tol, size, reps, flush,
              emit) -> bool:
    """K19's row; True where a check failed."""
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.ice.icepack import thermo_vertical as tv
    cfg = a["cfg"]
    ncat, N = a["hi"].shape
    new = lambda: tv.temperature_solve(**a)
    pick = lambda sol: tuple(sol[k] for k in BL99_OUTS)
    got = new()
    plain = tv.temperature_solve_plain(**a)
    torch.cuda.synchronize()
    n_new, n_plain = int(got["niter"]), int(plain["niter"])
    rel = max(float((got[k] - plain[k]).abs().max())
              / max(float(plain[k].abs().max()), 1e-300)
              for k in BL99_OUTS if k != "melting")
    row = dict(kernel="bl99_temperature_solve", dtype=tag,
               shape=[ncat, N], sweeps=n_new, sweeps_plain=n_plain,
               plain_rel_err=rel, plain_ok=rel <= tol and (
                   n_new == n_plain or dtype == torch.float32),
               plan=tv.bl99_plan("cuda", dtype, ncat * N))
    # the chunks this launch ran: its slots, read back through its entry
    mine, _, slots = bl99_entry(kernels.library(), a)
    mine()
    bits = slots.cpu().numpy()
    errs = (bits.view(np.float64) if dtype == torch.float64
            else bits.astype(np.uint32).view(np.float32))
    lens = tv.bl99_chunks(errs, cfg.niter_therm)
    row.update(sweep_maxima=[float(x) for x in errs[:sum(lens)]],
               chunks=lens, sweeps_run=sum(lens) + (
                   0 if sum(lens) == n_new else n_new - sum(lens[:-1])))
    calls = {"new": new}
    for name, lib in others.items():
        old, plan, _ = bl99_entry(lib, a)
        ref = old()
        torch.cuda.synchronize()
        row[name] = dict(plan=plan, sweeps=int(ref["niter"]),
                         against=compare(pick(got), pick(ref)))
        calls[name] = old
    b_ms, bound_by = kernels.bound_ms(tv.temperature_solve_work(
        ncat, N, cfg.nilyr, cfg.nslyr, size, n_plain,
        a["shcoef"] is not None, cfg.conduct), dtype)
    row.update(bound_us=b_ms * 1e3, bound_by=bound_by,
               times=turns(calls, "bl99_kernel", reps, flush))
    emit(**row)
    return not row["plain_ok"]


def time_itd(records, others, dtype, tag, size, reps, flush,
             emit) -> bool:
    """K20's rows, the remap with the rebin then the rebin alone; True
    where a check failed (the plain version's bits, or another kernel's
    but a cut variant's)."""
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.ice.icepack import itd
    failed = False
    for args, _ in records:
        cats, linear = args[:8], args[-1]
        ncat, n = cats[0].shape
        rows = 4 + sum(t.shape[1] for t in cats[4:])
        got = itd.itd_remap(*args)
        plain = itd.itd_remap_plain(*args)
        torch.cuda.synchronize()
        # nodes holding ice in some category, and the 32-node groups (a
        # warp's nodes) that hold any
        ice = (cats[0] > 1e-11).any(0)
        groups = torch.nn.functional.pad(ice, (0, -n % 32)).view(-1, 32)
        row = dict(kernel="itd_remap", dtype=tag,
                   call="remap + rebin" if linear else "rebin",
                   shape=[ncat, rows, n], plain_ok=same_bits(got, plain),
                   plan=itd.itd_remap_plan("cuda", dtype, ncat, n, linear),
                   nodes_with_ice=int(ice.sum()),
                   groups_with_ice=int(groups.any(1).sum()),
                   groups=groups.shape[0])
        calls = {"new": itd_entry(kernels.library(), args)[1]}
        for name, lib in others.items():
            call, launch = itd_entry(lib, args)
            row[name] = dict(against=compare((got,), (call(),)))
            calls[name] = launch
        b_ms, bound_by = kernels.bound_ms(itd.itd_remap_work(
            ncat, rows, n, size, linear), dtype)
        row.update(bound_us=b_ms * 1e3, bound_by=bound_by,
                   times=turns(calls, "itd_remap", reps, flush))
        emit(**row)
        failed |= not row["plain_ok"] or not all(
            row[name]["against"]["bitwise"] for name in others
            if not name.startswith("cut"))
    return failed


def time_dmoc(dargs, others, dtype, tag, tol, size, reps, flush,
              emit) -> bool:
    """K21's row; True where a check failed."""
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import diagnostics
    dens, *_, bins = dargs
    counts = diagnostics.dens_moc_bin_counts(dens, dargs[5], dargs[6], bins)
    new = lambda: diagnostics.dens_moc_bin(*dargs)
    got = new()
    plain = diagnostics.dens_moc_bin_plain(*dargs)
    torch.cuda.synchronize()
    rel = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-300)
              for g, w in zip(got, plain))
    row = dict(kernel="dens_moc_bin", dtype=tag, shape=list(got.shape),
               plain_rel_err=rel, plain_ok=rel <= tol,
               plan=diagnostics.dens_moc_bin_plan(dtype, bins.numel()),
               counts=dict(zip(("active_layers", "run_classes",
                                "nearest_layers", "wet_elements"),
                               counts[:4])),
               span_widths={w: n for w, n in enumerate(counts[4]) if n})
    calls = {"new": new}
    for name, lib in others.items():
        old = dmoc_entry(lib, dargs)
        ref = old()
        torch.cuda.synchronize()
        row[name] = dict(against=compare((got,), (ref,)))
        calls[name] = old
    b_ms, bound_by = kernels.bound_ms(diagnostics.dens_moc_bin_work(
        dens.shape[1], bins.numel(), size, *counts[:4], False), dtype)
    row.update(bound_us=b_ms * 1e3, bound_by=bound_by,
               times=turns(calls, "dens_moc_bin", reps, flush))
    emit(**row)
    return not row["plain_ok"]


if __name__ == "__main__":
    sys.exit(main())
