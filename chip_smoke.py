#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fesom2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each reported on its own line:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the hand-written CUDA kernels from ``fesom2_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. each kernel against its plain torch version on the card, at the
   shapes of its path, in float64 (within 1e-12 of max|plain| of each
   output) and float32 (1e-5): the soufflet step's four at the 2,875-node
   channel, ring_spmv and block_schwarz with the CG tables of the
   46,000-node zstar channel, pressure_bv (soufflet EoS) on both
   channels' states after one step, the probe's window_gather and
   onehot_gather (float32) at its shapes; then, on the full-width global
   mesh of phase 10 (its state after one step), pressure_bv (JM),
   kpp_column (double diffusion off and on) and the step kernels on its
   varying-depth tables, tridiag_solve at the step's three shapes (a, b,
   c [L, E], [L + 1, N] and [L, N] with two right-hand sides),
   block_schwarz with the globe's own preconditioner (the coupled step's
   445 blocks of 368 nodes; the channel's tables before it) and ring_spmv
   on the globe's ALE ring (the channel's before it); fct_bounds,
   tridiag_solve, elem_contrib_to_nodes and the probe kernels bitwise; a
   float32 kpp_column column beyond the tolerance passes only where
   rounding moved the boundary layer's last level, in at most 10 columns
   (or one in 10,000), and is reported; all timed with CUDA events
   (median of 30 after warm-up).  Beside each time stand the card's least
   time for the call (the larger of its bytes over 3.35 TB/s and its
   operations over the float32 or float64 peak, from the ``*_work``
   counter beside the wrapper, with which of the two binds) and, where
   one PyTorch call computes the same function on the same inputs (a CSR
   product, ``torch.bmm``, ``torch.gather``), that call's time; the port
   never makes such a call.  The cluster kernels' tile tables are
   reported with the sectors a tile's staging touches, and for the
   channel and the globe under both of its numberings (along the curve,
   as the step runs it, and by subdivision) what a 256-node tile touches
   through ``node_edges``, ``nod_in_elem`` and ``node_neighbors``; then
   ``node_edge_reduce``, ``elem_to_node_mean`` and ``fct_bounds`` are held
   against their plain versions on the subdivision-numbered globe and
   timed on both numberings in turns; ``onehot_gather``'s method bound is
   that of three bf16 products on the tensor cores, and ``torch.bmm`` is
   also timed over 50 calls between one pair of events; the sea ice's
   three kernels on the level-7 globe after one coupled step:
   ``elem_contrib_to_nodes`` at the six shapes the coupled step launches
   (the subdomain's two rows element-major; on the globe six rows
   vertex-major, nine, six, two by three and three rows element-major),
   each bitwise, with its call a step and their sum priced at these times
   (library call: a CSR product over the same incidence), ``mevp_stress``
   and ``mevp_node`` on the subdomain's tables,
   each against its plain version, then eight subcycles of the two kernels
   against eight of ``mevp_subcycle_plain``;
4. 20 float64 steps of the soufflet channel (2,875 nodes, 40 layers,
   linfs, dense SSH) through ``run.run_soufflet``, with sanity bounds,
   linfs volume conservation and a launch count above 0 for every kernel
   of that path;
5. 5 float64 steps on the card (kernels) against 5 on the CPU (plain
   versions) from the same state, within 1e-9 of max|CPU|;
6. setup seconds, then throughput of 30 float32 and 30 float64 steps
   after 2 warm-up steps, alternately and twice each, and a profile of 5
   float32 steps (information, not a gate);
7. the gather probe (``python -m fesom2_tpu_torch.scripts.
   gather_cost_model``): ``gather_probe()``, whose two kernels must equal
   its reference bitwise and launch, then ``main()``'s scans
   (information);
8. the zstar channel above the dense limit: 46,000 nodes (100 x 460, about
   5 km), 40 layers, CG free surface; 20 float64 steps through
   ``run.run_soufflet`` with the sanity bounds, area-mean hbar below 1e-6
   and every kernel of the path launched; CG iterations per step, setup
   seconds, then throughput in float32 and float64 (20 steps each,
   alternately and twice each);
9. the CG path card against CPU: the 2,875-node channel, zstar, with CG
   forced (``DENSE_SSH_MAX_NODES = 0``), 5 float64 steps, within 1e-8 of
   max|CPU|;
10. the ocean of the benched CI configuration at full width
    (``model.setup_pi_model`` + ``run.run_pi_ocean``): the level-7 globe
    of ``mesh/globe.py`` (163,842 vertices before the land mask, about
    114,000 ocean nodes, numbered along the curve), 47 layers, 96
    steps/day, CG free surface; 20
    float64 steps gated on finite fields, |u| < 3 m/s, T in [-3, 35] C,
    area-mean hbar below 1e-6 m and every kernel of the path launched;
    CG iterations per step, setup seconds, throughput in float32 and
    float64 (20 steps each, alternately and twice each), the launches of
    each kernel per step (the CG kernels also per iteration) and a 3-step
    profile per dtype (information);
11. the CI ocean card against CPU on the level-3 globe, 5 float64 steps:
    the dense solve within 1e-9 of max|CPU|, CG forced within 1e-8, and
    the dense solve with ``w_max_cfl=1e-5`` (the w split active: implicit
    vertical advection and the split FCT branch) within 1e-9;
12. the coupled ocean + ice step of the CI configuration at full width
    (``model.setup_pi_model``, ``pi_initial_state``,
    ``pi_coupled_step_fn`` with ``pi_config()`` as it stands: mEVP with 120
    subcycles on the subdomain poleward of 40 degrees, ice FCT advection,
    ice thermodynamics, NCAR bulk forcing from the code-built atmosphere):
    20 float64 steps on the level-7 globe gated on finite fields, the
    ocean bounds of phase 10 (the area-mean hbar against what the water
    flux handed to the ocean adds up to), 0 <= a_ice <= 1, m_ice and
    m_snow >= 0, some a_ice > 0.5, 0 < max|u_ice| < 3 m/s, no ice outside
    the subdomain, and every kernel of the path launched (``mevp_stress``
    and ``mevp_node`` 120 times a step, ``pressure_bv`` and ``kpp_column``
    once, ``tridiag_solve`` four times and ``elem_contrib_to_nodes``
    six times); then throughput in float32 and float64, a 3-step
    profile per dtype with the launches a step of each kernel counted in
    it (the same gates) and the CG kernels' device us a launch, and the
    subcycle loop's
    milliseconds per step with the kernels and with
    ``mevp_subcycle_plain`` (information);
13. the coupled step card against CPU on the level-3 globe, 3 float64
    steps, dense and CG forced: every ocean and ice field within 1e-8 of
    max|CPU| (the card's exp, pow and log differ from the CPU's in the
    last bits, and 120 subcycles, the Newton iterations of the ice
    surface temperature and three ocean steps carry them on).

Any failure exits non-zero before the last line.  Before it come one
JSON line with the gather kernels' device times on both numberings, one
with every kernel's launches, error, times, bound and library time (with
the device ms a coupled step spends in it, from phase 12's profiles, its
launches a float64 and a float32 coupled step, and the times of every
shape of tridiag_solve, elem_contrib_to_nodes, block_schwarz, ring_spmv
and kpp_column, the first two's calls a step also priced at those times), the
seconds the run took and the card; the last line is
``{"ok": true, "device": {...}}``.  It needs one card and exits non-zero
where CUDA is not available.
"""
import json
import subprocess
import sys
import time
from pathlib import Path


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def timed(fn, reps: int = 30, warmup: int = 5):
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def timed_batch(fn, calls: int = 50):
    """Milliseconds per call of fn() over ``calls`` calls between one pair
    of CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_kernels(prof):
    """The CUDA kernel events of a profile, without the device-side copies
    of ``record_function`` spans (the ``step.*`` annotations)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("step.")]


def device_us(fn, calls: int = 20):
    """Device microseconds per call of fn(): the summed self time of the
    CUDA kernels it launches, from torch.profiler, over ``calls`` calls;
    None where the profiler dropped every kernel event of the run (seen)."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    for _ in range(3):                  # a dropped trace is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total
                 for e in device_kernels(prof)) / calls
        if us > 0:
            return us
    return None


def us_text(us) -> str:
    return "not measured" if us is None else f"{us:.2f}"


def csr(rows, cols, vals, shape):
    """A CSR matrix on the card from (row, col, value) triples (duplicates
    summed): the operand of the sparse products timed as library calls."""
    import torch
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                   shape).coalesce().to_sparse_csr()


def profile_steps(phase: str, model, state, n: int, card: str, run=None,
                  also=()):
    """Profile n steps (``run(model, state, n)``, by default
    ``run_soufflet``): wall and device kernel time, the busy share, the
    kernels per step, the 12 costliest kernels, every kernel whose name
    holds one of ``also``, and the host time of each ``step.*`` span
    (information, not a gate).  Returns the device us per step of each
    CUDA kernel by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    from fesom2_tpu_torch.run import run_soufflet
    if run is None:
        def run(m, st, k):
            run_soufflet(k, model=m, state=st, verbose=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(model, state, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    dev_us = sum(e.self_device_time_total for e in kern)
    say(f"{phase} profile {str(model.dtype).replace('torch.', '')} {n} steps: "
        f"wall {wall * 1e3:.1f} ms, device kernel time {dev_us / 1e3:.1f} ms, "
        f"busy share {dev_us / 1e3 / (wall * 1e3):.3f}, kernels launched "
        f"{sum(e.count for e in kern) / n:.0f}/step ({card})")
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
    for e in ranked[:12] + [e for e in ranked[12:]
                            if any(a in e.key for a in also)]:
        say(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    for e in sorted((e for e in prof.key_averages()
                     if e.key.startswith("step.")
                     and e.device_type == DeviceType.CPU), key=lambda e: e.key):
        say(f"{phase} span {e.key:14s} host {e.cpu_time_total / 1e3 / n:8.3f} "
            f"ms/step")
    return {e.key: e.self_device_time_total / n for e in kern}


def max_abs(a, b):
    return float((a - b).abs().max())


def check_sane(phase: str, model, state, launches: dict):
    """The soufflet sanity bounds, the volume (area-mean hbar below 1e-6)
    and a launch count above 0 for every kernel of the path."""
    import torch
    m = model.mesh
    for name in ("u", "v", "eta", "hbar", "tr", "w"):
        if not torch.isfinite(getattr(state, name)).all():
            fail(f"{phase}: {name} is not finite")
    umax = float(state.u.abs().max())
    etamax = float(state.eta.abs().max())
    T = state.tr[0][m.node_layer_mask]
    a = m.area[0]
    hbar_int = float((state.hbar * a).sum() / a.sum())
    say(f"{phase} |u|max={umax:.4f} |eta|max={etamax:.4f} "
        f"T=[{float(T.min()):.4f}, {float(T.max()):.4f}] "
        f"mean hbar={hbar_int:.3e}")
    if not (umax < 3.0 and etamax < 2.0 and float(T.min()) > 0.0
            and float(T.max()) < 26.0):
        fail(f"{phase}: fields outside the sanity bounds")
    if abs(hbar_int) >= 1e-6:
        fail(f"{phase}: area-mean hbar {hbar_int:.3e} (volume)")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        fail(f"{phase}: kernels never launched on the path: {idle}")


def check_globe(phase: str, model, state, launches: dict,
                hbar_expected: float = 0.0):
    """The global ocean's bounds: every field finite, |u| < 3 m/s, T in
    [-3, 35] C, area-mean hbar within 1e-6 m of ``hbar_expected`` (0 where
    the water flux has zero mean; the coupled step's fluxes add up to a
    known mean) and a launch count above 0 for every kernel of the path."""
    import torch
    m = model.mesh
    for name in ("u", "v", "eta", "hbar", "tr", "w", "Kv", "Av", "hnode"):
        if not torch.isfinite(getattr(state, name)).all():
            fail(f"{phase}: {name} is not finite")
    umax = float(state.u.abs().max())
    T = state.tr[0][m.node_layer_mask]
    a = m.area[0]
    hbar_int = float((state.hbar * a).sum() / a.sum())
    say(f"{phase} |u|max={umax:.4f} |eta|max={float(state.eta.abs().max()):.4f} "
        f"T=[{float(T.min()):.4f}, {float(T.max()):.4f}] "
        f"mean hbar={hbar_int:.3e} |w_i|max={float(state.w_i.abs().max()):.3e} "
        f"max kpp_nonloc={float(state.kpp_nonloc.max()):.4f}")
    if not (umax < 3.0 and float(T.min()) > -3.0 and float(T.max()) < 35.0):
        fail(f"{phase}: fields outside the bounds")
    if abs(hbar_int - hbar_expected) >= 1e-6:
        fail(f"{phase}: area-mean hbar {hbar_int:.3e}, expected "
             f"{hbar_expected:.3e} (volume)")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        fail(f"{phase}: kernels never launched on the path: {idle}")


def kpp_flips(got, want, nlevels, tol):
    """Columns where kpp_column and its plain version differ beyond the
    tolerance, and among them those whose boundary layer ends at another
    level (the deepest interface with a nonlocal coefficient above 0, a
    proxy for kbl): a first crossing that rounding moved."""
    import torch
    bad = torch.zeros_like(nlevels, dtype=torch.bool)
    for g, w in zip(got, want):
        bad |= ((g - w).abs() > tol * w.abs().max()).any(0)
    lev = torch.arange(got[-1].shape[0], device=nlevels.device)[:, None]
    depth = lambda nl: torch.where(nl > 0, lev, -1).amax(0)
    flip = bad & (depth(got[-1]) != depth(want[-1]))
    return int(bad.sum()), int(flip.sum())


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA GPU")
    # the port, from the checkout this script lies in
    import numpy as np
    import fesom2_tpu_torch.model as port_model
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.kernels import build
    import copy
    from fesom2_tpu_torch.core import eos, ops, ssh, tracers
    from fesom2_tpu_torch.forcing.atmos import update_atm_forcing
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.ice.coupling import ocean2ice
    from fesom2_tpu_torch.ice.state import zero_ice_forcing
    from fesom2_tpu_torch.core.mixing import kpp
    from fesom2_tpu_torch.mesh import build_mesh, cluster, globe
    from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
    from fesom2_tpu_torch.model import (pi_coupled_step_fn, pi_initial_state,
                                        setup_pi_model, setup_soufflet_model)
    from fesom2_tpu_torch.run import (globe_ocean_inputs,
                                      ice_outside_subdomain, run_pi,
                                      run_pi_ocean, run_soufflet, step_info)
    from fesom2_tpu_torch.scripts import gather_cost_model as probe

    # phase 1 ------------------------------------------------------------
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 1 card: {card} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 2 ------------------------------------------------------------
    t0 = time.perf_counter()
    path = build.build()
    kernels.library()
    say(f"phase 2 build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in build.ptxas_report().splitlines():
        say(f"  {line.strip()}")

    # phase 3 ------------------------------------------------------------
    model64 = setup_soufflet_model(device=dev, dtype=torch.float64)
    mesh64 = model64.mesh
    N, E, Ed, L = mesh64.n_nodes, mesh64.n_elems, mesh64.n_edges, mesh64.nl - 1
    say(f"phase 3 mesh: N={N} E={E} Ed={Ed} layers={L} "
        f"K={mesh64.nod_in_elem.shape[1]} KE={mesh64.node_edges.shape[1]}")
    rng = np.random.default_rng(20261016)
    chan = {torch.float64: model64,
            torch.float32: setup_soufflet_model(device=dev,
                                                dtype=torch.float32)}
    meshes = {dtype: m.mesh for dtype, m in chan.items()}
    # pressure_bv's soufflet cases read each channel's state after one step
    chan1 = {dtype: run_soufflet(1, model=m, verbose=False)[1]
             for dtype, m in chan.items()}

    def rand(*shape, lo=-1.0, hi=1.0, dtype=torch.float64):
        return torch.as_tensor(rng.uniform(lo, hi, shape), device=dev).to(dtype)

    # the zstar channel above the dense limit: its CG tables feed phase 3,
    # its models phase 8
    big_path = write_mesh(channel_raw_mesh(nx=100, ny=460), str(
        Path(__file__).resolve().parent / "build" / "chip_smoke"
        / "channel_100x460"))
    big, big_setup = {}, {}
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big[dtype] = setup_soufflet_model(big_path, device=dev, dtype=dtype,
                                          which_ale="zstar")
        torch.cuda.synchronize()
        big_setup[dtype] = time.perf_counter() - t0
    big1 = {dtype: run_soufflet(1, model=m, verbose=False)[1]
            for dtype, m in big.items()}
    bm = big[torch.float64]
    pc64 = bm.ssh_block_pc
    say(f"phase 3 CG tables: N={bm.mesh.n_nodes} ring "
        f"{list(bm.ssh_ring.cols.shape)} ALE terms "
        f"{list(bm.ssh_ring.e_ids.shape)} blocks "
        f"{list(pc64.inv_blocks.shape)} slots {list(pc64.node_slots.shape)} "
        f"coarse {list(pc64.coarse_inv.shape)}")
    probe_vals, probe_idx = (torch.as_tensor(a, device=dev)
                             for a in probe.probe_inputs(**probe.PROBE_SHAPE))

    # the full-width global ocean of phase 10: its state after one step
    # feeds the column kernels here
    t0 = time.perf_counter()
    globe_path = globe.write_globe(str(
        Path(__file__).resolve().parent / "build" / "chip_smoke"
        / "globe_l7"), level=7)
    say(f"phase 3 level-7 globe written in {time.perf_counter() - t0:.2f} s")
    gm, gatm, gm_setup, gin, g1 = {}, {}, {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gm[dtype], gatm[dtype] = setup_pi_model(globe_path, device=dev,
                                                dtype=dtype)
        torch.cuda.synchronize()
        gm_setup[dtype] = time.perf_counter() - t0
        gin[dtype] = globe_ocean_inputs(gm[dtype], seed=0)
        g1[dtype] = run_pi_ocean(gm[dtype], *gin[dtype], 1)
    gmesh = gm[torch.float64].mesh
    say(f"phase 3 globe: N={gmesh.n_nodes} E={gmesh.n_elems} "
        f"Ed={gmesh.n_edges} layers={gmesh.nl - 1} levels per column "
        f"{int(gmesh.nlevels_node.min())}-{int(gmesh.nlevels_node.max())}")

    pbv_fields = ("density_m_rho0", "hpressure", "bvfreq", "dbsfc", "mld2")

    # A case: (kernel, label, wrapper call, plain call, exact, work,
    # library call or None).  ``work`` is the kernel's (bytes, flops) from
    # its counter beside the wrapper; the library call is one PyTorch call
    # that computes the same function on the same inputs (timed here,
    # never called by the port).

    def pbv_case(label, m, st):
        """pressure_bv's outputs on model m's state st, with m's EoS."""
        L, N = m.mesh.nl - 1, m.mesh.n_nodes
        wet = int(m.mesh.node_layer_mask.sum())
        def outputs(state):        # one call, five fields
            return tuple(getattr(state, k) for k in pbv_fields)
        return ("pressure_bv", f"{label} [{L}, {N}]",
                lambda: outputs(eos.pressure_bv(st, m.mesh, m.cfg,
                                                m.density_ref)),
                lambda: outputs(eos.pressure_bv_plain(st, m.mesh, m.cfg,
                                                      m.density_ref)),
                False, eos.pressure_bv_work(L, N, wet, eos._eos_kind(m.cfg),
                                            st.tr.element_size()), None)

    def bs_case(label, m, dtype):
        """block_schwarz with model m's preconditioner on a random
        residual; library call: one bmm, the blocks' local solves only."""
        pc, N = m.ssh_block_pc, m.mesh.n_nodes
        size = torch.empty((), dtype=dtype).element_size()
        x = rand(N, dtype=dtype)
        nb, K = pc.block_ids.shape
        rb = x[pc.block_ids.long().clamp_min(0)][..., None].contiguous()
        return ("block_schwarz", f"{label} blocks [{nb}, {K}, {K}] (library: "
                f"local solves only)",
                lambda: pc(x),
                lambda: ssh.block_schwarz_plain(pc, x), False,
                ssh.block_schwarz_work(N, nb, K, pc.node_slots.shape[1],
                                       pc.coarse_ids.shape[1], size),
                lambda: torch.bmm(pc.inv_blocks, rb))

    def cg_cases(dtype):
        """The CG path's kernels with the 46k channel's tables; the ring
        values rebuilt from a 0.5 m hbar perturbation, as a step does;
        pressure_bv on its zstar state after one step.  Library calls: a
        CSR product for the ring, one bmm for the blocks' local solves."""
        m = big[dtype]
        return [ring_case("channel", m, dtype),
                bs_case("channel", m, dtype),
                pbv_case("zstar channel", m, big1[dtype])]

    def probe_cases():
        """Library calls: torch.gather on a prebuilt index, torch.bmm on a
        prebuilt one-hot.  Both kernels compute one function, a gather, and
        are held to its bound; what the one-hot product costs as a method
        is reported beside it (method_bound_ms)."""
        v, i = probe_vals, probe_idx
        G, W, NL = v.shape
        T = i.shape[1]
        label = "G,W,T,NL " + ",".join(map(str, probe.PROBE_SHAPE.values()))
        rows_read = int(torch.unique(
            i.long() + W * torch.arange(G, device=dev)[:, None]).numel())
        index = i.long()[..., None].expand(G, T, NL).contiguous()
        onehot = (i.long()[..., None] == torch.arange(W, device=dev)).to(
            v.dtype)
        return [("window_gather", label,
                 lambda: probe.window_gather(v, i),
                 lambda: probe.window_gather_plain(v, i), True,
                 probe.window_gather_work(G, T, NL, rows_read),
                 lambda: torch.gather(v, 1, index)),
                ("onehot_gather", label,
                 lambda: probe.onehot_gather(v, i),
                 lambda: probe.onehot_gather_plain(v, i), True,
                 probe.window_gather_work(G, T, NL, rows_read),
                 lambda: torch.bmm(onehot, v))]

    def cases(dtype, label, model, state, full=True):
        """The step kernels at the shapes of model's path, pressure_bv on
        its state ``state``; ``full=False`` runs fewer shapes of each.  The
        last case of a kernel is the one its row of the result reports.
        Library calls: a CSR product with the signed incidence matrix for
        the divergence, with the area weights for the unmasked mean."""
        mesh = model.mesh
        N, E, Ed, L = mesh.n_nodes, mesh.n_elems, mesh.n_edges, mesh.nl - 1
        K, KE = mesh.nod_in_elem.shape[1], mesh.node_edges.shape[1]
        size = torch.empty((), dtype=dtype).element_size()
        ct = mesh.cluster
        out = []
        f = rand(2, L, Ed, dtype=dtype)
        out.append(("node_edge_reduce", f"pair {list(f.shape)}",
                    lambda f=f: ops.edge_signed_reduce2(f, mesh),
                    lambda f=f: ops.edge_signed_reduce2_plain(f, mesh), False,
                    ops.node_edge_reduce_work(2 * L, Ed, N, KE, True, size),
                    None))
        ne = mesh.node_edges.long()
        inc = csr(torch.arange(N, device=dev)[:, None].expand_as(ne)[ne >= 0],
                  ne[ne >= 0], mesh.node_edge_sign[ne >= 0], (N, Ed))
        for R in ((), (L,), (2, L)) if full else ((2, L),):
            f = rand(*R, Ed, dtype=dtype)
            ft = f.reshape(-1, Ed).T.contiguous()
            out.append(("node_edge_reduce", f"div {list(f.shape)}",
                        lambda f=f: ops.edge_divergence(f, mesh),
                        lambda f=f: ops.edge_divergence_plain(f, mesh), False,
                        ops.node_edge_reduce_work(ft.shape[1], Ed, N, KE,
                                                  False, size),
                        lambda ft=ft: inc @ ft))
        xs = rand(2, E, dtype=dtype)
        out.append(("elem_to_node_mean", f"flat {list(xs.shape)}",
                    lambda: ops.elem_to_node_mean_flat(xs, mesh),
                    lambda: ops.elem_to_node_mean_flat_plain(xs, mesh), False,
                    ops.elem_to_node_mean_work(2, 1, E, N, K, size), None))
        nie = mesh.nod_in_elem.long()
        w = mesh.elem_area[nie.clamp_min(0)] * (nie >= 0)
        mean = csr(torch.arange(N, device=dev)[:, None].expand_as(nie)[
            nie >= 0], nie[nie >= 0], (w / w.sum(1, keepdim=True))[nie >= 0],
            (N, E))
        # every row count the path gives it (gm_redi: 4 rows), on both meshes
        for shape, lev in (((2, L, E), False), ((2, 2, L, E), True),
                           ((2, L, E), True)):
            x = rand(*shape, dtype=dtype)
            xt = x.reshape(-1, E).T.contiguous()
            out.append(("elem_to_node_mean", f"levels={lev} {list(shape)}",
                        lambda x=x, lev=lev: ops.elem_to_node_mean(x, mesh, lev),
                        lambda x=x, lev=lev: ops.elem_to_node_mean_plain(
                            x, mesh, lev), False,
                        ops.elem_to_node_mean_work(
                            xt.shape[1] // L, L, E, N, K, size,
                            ct.mean_tile_elems.numel(), ct.tile_nodes),
                        None if lev else (lambda xt=xt: mean @ xt)))
        # the three shapes of the step: momentum on elements, gm_redi's
        # nl rows, the tracers' two solves (last: the row of the result)
        for R, X in ((L, E), (L + 1, N), (L, N)):
            a = rand(R, X, lo=-0.4, hi=0.0, dtype=dtype)
            c = rand(R, X, lo=-0.4, hi=0.0, dtype=dtype)
            b = rand(R, X, lo=1.0, hi=2.0, dtype=dtype)
            d = rand(2, R, X, dtype=dtype)
            out.append(("tridiag_solve",
                        f"{label} a,b,c {[R, X]} d {[2, R, X]}",
                        lambda a=a, b=b, c=c, d=d: ops.tridiag_solve(a, b, c, d),
                        lambda a=a, b=b, c=c, d=d: ops.tridiag_solve_plain(
                            a, b, c, d), True,
                        ops.tridiag_solve_work(2, R, X, size), None))
        ttf = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        lo_ = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        out.append(("fct_bounds", f"ttf,lo {[2, L, N]}",
                    lambda: tracers.fct_bounds(ttf, lo_, mesh),
                    lambda: tracers.fct_bounds_plain(ttf, lo_, mesh), True,
                    tracers.fct_bounds_work(
                        2, L, N, ct.fct_slot.shape[0], size,
                        ct.fct_tile_nodes.numel(), ct.tile_nodes), None))
        out.append(pbv_case(label, model, state))
        return out

    def ring_case(label, m, dtype):
        """ring_spmv with model m's ALE ring, its values rebuilt from a
        0.5 m hbar perturbation as a step does; library call: a CSR
        product."""
        size = torch.empty((), dtype=dtype).element_size()
        hbar_e = rand(m.mesh.n_elems, lo=-0.5, hi=0.5, dtype=dtype)
        op = m.ssh_ring.materialize(hbar_e)
        N = m.mesh.n_nodes
        x = rand(N, dtype=dtype)
        Kr = op.cols.shape[0]
        ring = csr(torch.arange(N, device=dev).repeat(Kr),
                   op.cols.long().reshape(-1), op.vals.reshape(-1), (N, N))
        xcol = x[:, None].contiguous()
        return ("ring_spmv", f"{label} ring {list(op.cols.shape)}",
                lambda: op(x),
                lambda: ssh.ring_spmv_plain(op.cols, op.vals, x), False,
                ssh.ring_spmv_work(Kr, N, size), lambda: ring @ xcol)

    def globe_cases(dtype):
        """The step kernels on the globe's varying-depth tables, then
        pressure_bv and kpp_column on its state after one step, and
        block_schwarz and ring_spmv with the globe's own CG tables (the
        coupled step's; the last case of each, so its row of the
        result)."""
        m, st, f = gm[dtype], g1[dtype], gin[dtype][1]
        mesh = m.mesh
        wet = int(mesh.node_layer_mask.sum())
        out = cases(dtype, "globe", m, st, full=False)
        out.append(bs_case("globe", m, dtype))
        out.append(ring_case("globe", m, dtype))
        # the step's case (no double diffusion) last: the row of the result
        for dd in (True, False):
            cfg = copy.deepcopy(m.cfg)
            cfg.tra.double_diffusion = dd
            args = kpp.column_inputs(st, mesh, cfg, f)
            out.append(("kpp_column", f"globe dd={dd}",
                        lambda a=args: tuple(x for x in kpp.kpp_column(*a)
                                             if x is not None),
                        lambda a=args: tuple(x for x in kpp.kpp_column_plain(
                            *a) if x is not None), False,
                        kpp.kpp_column_work(mesh.nl, mesh.n_nodes, wet, dd,
                                            st.tr.element_size()), None))
        return out

    ice_tables = {}
    ecn_calls = {}      # elem_contrib_to_nodes: calls a coupled step by shape

    def ice_cases(dtype):
        """The sea ice's kernels on the level-7 globe, at its state after
        one coupled step: elem_contrib_to_nodes at the six shapes of the
        step, on the subdomain's tables and on the whole globe (library
        call: a CSR product over the same incidence), mevp_stress and
        mevp_node on the subdomain's tables.
        The mEVP kernels work in place: they are compared on copies and
        timed on buffers of their own (an eighth item)."""
        m, atm = gm[dtype], gatm[dtype]
        mesh, cap = m.mesh, m.ice_sub
        size = torch.empty((), dtype=dtype).element_size()
        st, ice = pi_initial_state(m)
        st, ice, _ = pi_coupled_step_fn(m, atm)(st, ice, 0)
        with torch.no_grad():
            surf = ocean2ice(st, mesh)
            iforc = update_atm_forcing(
                atm, m.cfg.dt, ice.u_ice, ice.v_ice, surf.u_w, surf.v_w,
                surf.T_oc, zero_ice_forcing(mesh, dtype))
            ice_l, forc_l, surf_l = evp.subdomain_inputs(ice, cap, iforc,
                                                         surf)
            tab = evp.mevp_setup(ice_l, cap, forc_l, surf_l, m.cfg)
        uv0 = torch.stack([ice_l.u_ice, ice_l.v_ice])
        sig0 = torch.stack([ice_l.sigma11, ice_l.sigma12, ice_l.sigma22])
        ice_tables[dtype] = (tab, uv0, sig0, cap)
        Ns, Es, Ks = cap.n_nodes, cap.n_elems, cap.nod_in_elem.shape[1]
        if dtype == torch.float64:
            say(f"phase 3 ice subdomain: {Ns} of {mesh.n_nodes} nodes, {Es} "
                f"of {mesh.n_elems} elements, K={Ks}; nodes with ice "
                f"{int(tab.node_c[12].sum())}, elements with ice "
                f"{int(tab.elem_c[9].sum())}, max|u_ice| "
                f"{float(uv0.abs().max()):.4f} m/s after one coupled step")
        out = []
        # the six calls of the coupled step, each with the call site that
        # gives it (the last, the largest: the row of the result)
        for label, tables, lead, vertex_major, calls, site in (
                ("subdomain", cap, (2,), False, 1, "ice/evp.py mevp_setup"),
                ("globe", mesh, (6,), True, 1, "ice/fct.py ice_tg_rhs_div"),
                ("globe", mesh, (6,), False, 1,
                 "ice/fct.py _lumped_iterate, second product"),
                ("globe", mesh, (2, 3), False, 1, "ice/fct.py ppair"),
                ("globe", mesh, (3,), False, 1, "ice/fct.py out"),
                ("globe", mesh, (9,), False, 1,
                 "ice/fct.py _lumped_iterate, first product with the "
                 "low-order fields")):
            n_e, n_n = tables.n_elems, tables.n_nodes
            x = rand(*lead, *((3, n_e) if vertex_major else (n_e, 3)),
                     dtype=dtype)
            rows = x.numel() // (3 * n_e)
            ecn_calls[f"{label} {list(x.shape)}"] = {
                "launches_per_coupled_step": calls, "site": site}
            idx, valid = ops._contrib_index(tables, vertex_major)
            inc = csr(torch.arange(n_n, device=dev)[:, None].expand_as(idx)[
                valid], idx[valid], torch.ones(int(valid.sum()), dtype=dtype,
                                               device=dev), (n_n, 3 * n_e))
            xt = x.reshape(rows, -1).T.contiguous()
            fn = ops.elem_contrib_to_nodes_3e if vertex_major \
                else ops.elem_contrib_to_nodes
            out.append((
                "elem_contrib_to_nodes", f"{label} {list(x.shape)}",
                lambda x=x, t=tables, fn=fn: fn(x, t),
                lambda x=x, t=tables, vm=vertex_major:
                ops.elem_contrib_to_nodes_plain(x, t, vm), True,
                ops.elem_contrib_to_nodes_work(
                    rows, n_e, n_n, tables.nod_in_elem.shape[1], size),
                lambda inc=inc, xt=xt: inc @ xt))
        work = evp.mevp_subcycle_work(Ns, Es, Ks, size)
        fuv0 = evp.mevp_stress_plain(uv0, sig0, tab)[1].contiguous()
        sig_t, uv_t = sig0.clone(), uv0.clone()
        out.append(("mevp_stress", f"subdomain uv {[2, Ns]} sig {[3, Es]}",
                    lambda: tuple(x.clone() for x in evp.mevp_stress(
                        uv0, sig0.clone(), tab, cap)),
                    lambda: evp.mevp_stress_plain(uv0, sig0, tab), False,
                    work["mevp_stress"], None,
                    lambda: evp.mevp_stress(uv0, sig_t, tab, cap)))
        out.append(("mevp_node", f"subdomain uv {[2, Ns]} fuv {[2, 3, Es]}",
                    lambda: evp.mevp_node(uv0.clone(), fuv0, tab, cap),
                    lambda: evp.mevp_node_plain(uv0, fuv0, tab, cap), False,
                    work["mevp_node"], None,
                    lambda: evp.mevp_node(uv_t, fuv0, tab, cap)))
        return out

    for label, mesh in (("channel", mesh64), ("globe", gmesh)):
        ct = mesh.cluster
        for what, ptr, ids in (
                ("elements", ct.mean_tile_ptr, ct.mean_tile_elems),
                ("neighbour nodes", ct.fct_tile_ptr, ct.fct_tile_nodes)):
            st8, st4 = (cluster.tile_stats(ptr, ids, b) for b in (8, 4))
            say(f"phase 3 cluster tables {label}: {st8['tiles']} tiles of "
                f"{ct.tile_nodes} nodes, per tile "
                f"{st8['entries_per_tile']:.1f} distinct {what} in "
                f"{st8['sectors_per_tile']:.1f} (float64) and "
                f"{st4['sectors_per_tile']:.1f} (float32) 32-byte sectors "
                f"of a field row")

    # the globe once more, numbered as the subdivision leaves it: the same
    # mesh under a permutation, for the gather kernels' times on both
    t0 = time.perf_counter()
    sub_path = globe.write_globe(str(
        Path(__file__).resolve().parent / "build" / "chip_smoke"
        / "globe_l7_subdivision"), level=7, numbering="subdivision")
    sub = {dtype: build_mesh(sub_path, force_rotation=True,
                             cyclic_length_deg=360.0, use_partial_cell=True,
                             dtype=dtype, device=dev)
           for dtype in (torch.float64, torch.float32)}
    say(f"phase 3 level-7 globe in subdivision numbering written and its "
        f"tables built twice in {time.perf_counter() - t0:.2f} s")
    for label, mesh in (("channel", mesh64), ("globe along the curve", gmesh),
                        ("globe by subdivision", sub[torch.float64])):
        for what, table in (("edges", mesh.node_edges),
                            ("elements", mesh.nod_in_elem),
                            ("neighbour nodes", mesh.node_neighbors)):
            st8, st4 = (cluster.table_tile_stats(table, cluster.TILE_NODES, b)
                        for b in (8, 4))
            say(f"phase 3 locality {label}: a tile of {cluster.TILE_NODES} "
                f"nodes names {st8['entries_per_tile']:.1f} distinct {what} "
                f"in {st8['sectors_per_tile']:.1f} (float64) and "
                f"{st4['sectors_per_tile']:.1f} (float32) 32-byte sectors of "
                f"a field row; its warps' gathers ask for "
                f"{st8['warp_sectors_per_tile']:.1f} and "
                f"{st4['warp_sectors_per_tile']:.1f}")

    summary = {k: {"max_abs_err": 0.0} for k in kernels.KERNELS}
    numbering_us = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tag = str(dtype).replace("torch.", "")
        for name, label, kern, plain, exact, work, library, *own in (
                cases(dtype, "channel", chan[dtype], chan1[dtype])
                + cg_cases(dtype)
                + (probe_cases() if dtype == torch.float32 else [])
                + globe_cases(dtype) + ice_cases(dtype)):
            # an in-place kernel is timed on buffers of its own
            kern_t = own[0] if own else kern
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_abs(g, w) for g, w in zip(got, want))
            # each output against its own largest magnitude
            rel = max(max_abs(g, w) / max(float(w.abs().max()), 1e-300)
                      for g, w in zip(got, want))
            if exact:
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
            else:
                ok = rel <= tol
            if not ok and name == "kpp_column" and dtype == torch.float32:
                # a boundary-layer depth that f32 rounding moves across a
                # level: reported; passes only if every column beyond the
                # tolerance is such a move, in a few columns
                nbad, nflip = kpp_flips(got, want, gmesh.nlevels_node, tol)
                say(f"phase 3 kpp_column f32 {label}: {nbad} columns beyond "
                    f"{tol} of max|plain|, {nflip} of them with the "
                    f"boundary layer ending at another level (kbl moved by "
                    f"rounding)")
                ok = nflip == nbad <= max(10, gmesh.n_nodes // 10000)
            if not ok or not all(torch.isfinite(g).all() for g in got):
                fail(f"{name} {label} {tag}: kernel vs plain max abs err "
                     f"{err:.3e}, worst output {rel:.3e} of its max|plain| "
                     f"(tol {'bitwise' if exact else tol})")
            if library is not None and name in ("node_edge_reduce",
                                                "elem_to_node_mean",
                                                "ring_spmv",
                                                "elem_contrib_to_nodes"):
                # the sparse products give the kernel's output transposed
                lib = library().T.reshape(got[0].shape)
                lib_rel = max_abs(lib, want[0]) / float(want[0].abs().max())
                if not lib_rel <= 10 * tol:
                    fail(f"{name} {label} {tag}: the library call computes "
                         f"another function ({lib_rel:.3e} of max|plain|)")
            k_ms = timed(kern_t)
            p_ms = timed(plain)
            l_ms = timed(library) if library is not None else None
            b_ms, bound_by = kernels.bound_ms(work, dtype)
            k_dev, l_dev = device_us(kern_t), None
            if library is not None:
                l_dev = device_us(library)
            say(f"phase 3 {name:21s} {tag} {label:36s} max_abs_err={err:.3e} "
                f"rel={rel:.3e} "
                f"kernel_us={k_ms * 1e3:.1f} plain_us={p_ms * 1e3:.1f} "
                f"library_us={'none' if l_ms is None else f'{l_ms * 1e3:.1f}'} "
                f"bound_us={b_ms * 1e3:.1f} ({bound_by}) "
                f"device: kernel_us={us_text(k_dev)} "
                f"plain_us={us_text(device_us(plain))} library_us="
                f"{'none' if library is None else us_text(l_dev)}")
            # every shape of the kernels whose step calls take several
            if (name == "tridiag_solve" and label.startswith("globe")) \
                    or name in ("block_schwarz", "elem_contrib_to_nodes",
                                "kpp_column", "ring_spmv"):
                summary[name].setdefault("shapes", {})[f"{tag} {label}"] = {
                    "ms": k_ms, "device_ms": k_dev and k_dev / 1e3,
                    "bound_ms": b_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "library_device_ms": l_dev and l_dev / 1e3,
                    **ecn_calls.get(label, {})}
            if dtype == torch.float64 or name.endswith("_gather"):
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                # the largest shape of each kernel on its path is timed
                # last among its f64 cases (the probe kernels: f32 only)
                s.update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=bound_by,
                         device_ms=k_dev and k_dev / 1e3,
                         library_device_ms=l_dev and l_dev / 1e3)
            if name == "onehot_gather":
                work = probe.onehot_gather_work(*probe.PROBE_SHAPE.values())
                m_ms, m_by = kernels.bound_ms(
                    work, dtype, kernels.PEAK_TENSOR_FLOPS[torch.bfloat16])
                lb_ms = timed_batch(library)
                summary[name].update(method_bound_ms=m_ms,
                                     library_batch_ms=lb_ms)
                say(f"phase 3 onehot_gather: the one-hot product as a method "
                    f"(three bf16 products on the tensor cores, "
                    f"{work[1] / 1e9:.1f} GFLOP at 989 TFLOP/s; "
                    f"{work[0] / 1e6:.1f} MB at 3.35 TB/s) is bound at "
                    f"{m_ms * 1e3:.1f} us ({m_by}); torch.bmm on the prebuilt "
                    f"one-hot, 50 calls between one pair of events: "
                    f"{lb_ms * 1e3:.1f} us a call")

    # eight subcycles of the two mEVP kernels against eight of the plain
    # version, from the ice state after one coupled step
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tab, uv0, sig0, cap = ice_tables[dtype]
        uv_k, sig_k = uv0.clone(), sig0.clone()
        uv_p, sig_p = uv0, sig0
        for _ in range(8):
            uv_k, sig_k = evp.mevp_subcycle(uv_k, sig_k, tab, cap)
            uv_p, sig_p = evp.mevp_subcycle_plain(uv_p, sig_p, tab, cap)
        torch.cuda.synchronize()
        rel = {k: max_abs(a, b) / float(b.abs().max())
               for k, a, b in (("uv", uv_k, uv_p), ("sig", sig_k, sig_p))}
        bitwise = torch.equal(uv_k, uv_p) and torch.equal(sig_k, sig_p)
        moved = float((uv_p - uv0).abs().max())
        say(f"phase 3 mevp 8 subcycles {str(dtype).replace('torch.', '')}: "
            f"kernels vs plain uv {rel['uv']:.3e} sig {rel['sig']:.3e} of "
            f"max|plain|, bit-equal: {bitwise}; the velocities moved by "
            f"{moved:.3e} m/s")
        if not (max(rel.values()) <= tol and moved > 0.0
                and torch.isfinite(uv_k).all() and torch.isfinite(sig_k).all()):
            fail(f"phase 3: 8 mEVP subcycles, kernels vs plain {rel} "
                 f"(tol {tol})")

    # the three gather kernels on both numberings of the level-7 globe:
    # held against plain on the subdivision numbering too, then timed in
    # turns (curve, subdivision, subdivision, curve): the profiler's device
    # us, and us per call of 20 calls between one pair of events
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tag = str(dtype).replace("torch.", "")
        timings = {}
        for turn, (label, mesh) in enumerate((
                ("curve", gm[dtype].mesh), ("subdivision", sub[dtype]),
                ("subdivision", sub[dtype]), ("curve", gm[dtype].mesh))):
            L_, N_, E_, Ed_ = (mesh.nl - 1, mesh.n_nodes, mesh.n_elems,
                               mesh.n_edges)
            f = rand(2, L_, Ed_, dtype=dtype)
            x = rand(2, L_, E_, dtype=dtype)
            ttf = rand(2, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
            lo_ = rand(2, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
            for name, kern, plain, exact in (
                    ("node_edge_reduce div",
                     lambda: ops.edge_divergence(f, mesh),
                     lambda: ops.edge_divergence_plain(f, mesh), False),
                    ("node_edge_reduce pair",
                     lambda: ops.edge_signed_reduce2(f, mesh),
                     lambda: ops.edge_signed_reduce2_plain(f, mesh), False),
                    ("elem_to_node_mean",
                     lambda: ops.elem_to_node_mean(x, mesh),
                     lambda: ops.elem_to_node_mean_plain(x, mesh), False),
                    ("fct_bounds",
                     lambda: tracers.fct_bounds(ttf, lo_, mesh),
                     lambda: tracers.fct_bounds_plain(ttf, lo_, mesh), True),
                    ("torch gather flux[..., node_edges]",
                     lambda: f[..., mesh.node_edges.long().clamp_min(0)],
                     None, False)):
                if plain is not None and turn == 1:
                    got, want = kern(), plain()
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    rel = max(max_abs(g, w) / float(w.abs().max())
                              for g, w in zip(got, want))
                    if not (all(torch.equal(g, w) for g, w in zip(got, want))
                            if exact else rel <= tol):
                        fail(f"{name} {tag} on the subdivision numbering: "
                             f"{rel:.3e} of max|plain|")
                timings.setdefault((name, label), []).append(
                    (device_us(kern), timed_batch(kern, 20) * 1e3))
        for (name, label), us in timings.items():
            say(f"phase 3 numbering {tag} {name:36s} {label:12s} device_us="
                f"{' '.join(us_text(u) for u, _ in us)} us a call of 20 "
                f"between two events={' '.join(f'{b:.2f}' for _, b in us)}")
            numbering_us.setdefault(name, {}).setdefault(tag, {})[label] = {
                "device_us": [u for u, _ in us],
                "batch_us": [b for _, b in us]}

    # a NaN in ttf must spread through fct_bounds as through torch.maximum
    for dtype in (torch.float64, torch.float32):
        mesh = meshes[dtype]
        ttf = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        lo_ = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        ttf[0, L // 2, N // 2] = float("nan")
        got = tracers.fct_bounds(ttf, lo_, mesh)
        want = tracers.fct_bounds_plain(ttf, lo_, mesh)
        n_nan = [int(w.isnan().sum()) for w in want]
        same = all(torch.equal(g.isnan(), w.isnan())
                   and torch.equal(g[~g.isnan()], w[~w.isnan()])
                   for g, w in zip(got, want))
        say(f"phase 3 fct_bounds NaN input {dtype}: NaN outputs {n_nan}, "
            f"kernel equals plain: {same}")
        if not same or min(n_nan) == 0:
            fail("phase 3: fct_bounds does not propagate NaN as plain does")

    # the probe kernels equal each other; an index outside [0, W) gives a
    # NaN row in kernels and plain versions alike
    v, i = probe_vals, probe_idx.clone()
    W = v.shape[1]
    if not torch.equal(probe.window_gather(v, i), probe.onehot_gather(v, i)):
        fail("phase 3: window_gather and onehot_gather differ")
    i[0, 0], i[7, 100], i[300, 255] = W, W + 1000, -W - 1
    outs = [probe.window_gather(v, i), probe.onehot_gather(v, i),
            probe.window_gather_plain(v, i), probe.onehot_gather_plain(v, i)]
    n_nan = [int(o.isnan().any(-1).sum()) for o in outs]
    same = all(torch.equal(o.isnan(), outs[0].isnan())
               and torch.equal(o.nan_to_num(), outs[0].nan_to_num())
               for o in outs)
    say(f"phase 3 probe kernels, 3 indices outside the window: NaN rows "
        f"{n_nan}, kernels equal plain and each other: {same}")
    if not same or n_nan != [3] * 4:
        fail("phase 3: the probe kernels do not fill outside the window as "
             "the plain versions do")

    # phase 4 ------------------------------------------------------------
    step_kernels = ("node_edge_reduce", "elem_to_node_mean", "tridiag_solve",
                    "fct_bounds", "pressure_bv")
    kernels.reset_launches()
    model, state, timers = run_soufflet(20, model=model64, verbose=False)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in step_kernels}
    say(f"phase 4 soufflet 20 steps float64: {timers.step:.3f} s stepping, "
        f"launches {launches}")
    check_sane("phase 4", model, state, launches)
    path_launches = dict(launches)

    # phase 5 ------------------------------------------------------------
    model_cpu = setup_soufflet_model(device="cpu", dtype=torch.float64)
    s_gpu = model64.initial_state()
    s_cpu = model_cpu.initial_state()
    _, s_gpu, _ = run_soufflet(5, model=model64, state=s_gpu, verbose=False)
    _, s_cpu, _ = run_soufflet(5, model=model_cpu, state=s_cpu, verbose=False)
    for name in ("u", "v", "eta", "hbar", "tr"):
        ref = getattr(s_cpu, name)
        rel = max_abs(getattr(s_gpu, name).cpu(), ref) / float(ref.abs().max())
        say(f"phase 5 card vs cpu {name}: {rel:.3e} of max|cpu|")
        if not rel <= 1e-9:
            fail(f"phase 5: {name} card vs CPU {rel:.3e} > 1e-9")

    # phase 6 ------------------------------------------------------------
    # the step is host-bound, so its rate drifts with the shared host: the
    # two dtypes are measured alternately, twice each
    runs = {}
    for dtype in (torch.float32, torch.float64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mdl = setup_soufflet_model(device=dev, dtype=dtype)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        st = mdl.initial_state()
        _, st, _ = run_soufflet(2, model=mdl, state=st, verbose=False)
        runs[dtype] = [mdl, st]
        say(f"phase 6 setup {str(dtype).replace('torch.', '')}: {setup_s:.3f} s "
            f"(mesh tables, tracer statics, dense SSH inverse)")
    for _ in range(2):
        for dtype, run in runs.items():
            mdl, st = run
            torch.cuda.synchronize()
            n = 30
            t0 = time.perf_counter()
            _, st, _ = run_soufflet(n, model=mdl, state=st, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run[1] = st
            if not torch.isfinite(st.eta).all():
                fail("phase 6: eta is not finite")
            wet = int(mdl.mesh.node_layer_mask.sum())
            say(f"phase 6 throughput {str(dtype).replace('torch.', '')}: "
                f"{n / wall:.3f} steps/s, {wet * n / wall:.6e} wet "
                f"node-levels/s ({wet} wet node-levels; {card})")
    mdl, st = runs[torch.float32]
    profile_steps("phase 6", mdl, st, 5, card)

    # phase 7 ------------------------------------------------------------
    kernels.reset_launches()
    probe_res = probe.gather_probe()
    torch.cuda.synchronize()
    for k in ("window_gather", "onehot_gather"):
        path_launches[k] = kernels.LAUNCHES[k]
    say(f"phase 7 probe launches {({k: path_launches[k] for k in probe_res})}"
        f" ({card})")
    if min(path_launches[k] for k in probe_res) <= 0:
        fail("phase 7: a probe kernel was never launched")
    probe.main()

    # phase 8 ------------------------------------------------------------
    big_wet = int(bm.mesh.node_layer_mask.sum())
    for dtype, sec in big_setup.items():
        say(f"phase 8 setup {str(dtype).replace('torch.', '')}: {sec:.3f} s "
            f"(N={bm.mesh.n_nodes}: mesh tables, tracer statics, block "
            f"preconditioner, ALE ring)")
    cg_kernels = step_kernels + ("ring_spmv", "block_schwarz")
    kernels.reset_launches()
    st = bm.initial_state()
    iters = []
    t0 = time.perf_counter()
    for _ in range(20):
        _, st, _ = run_soufflet(1, model=bm, state=st, verbose=False)
        iters.append(bm.ssh_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in cg_kernels}
    say(f"phase 8 zstar CG 20 steps float64: {wall:.3f} s, CG iterations per "
        f"step {iters}, launches {launches}")
    check_sane("phase 8", bm, st, launches)
    for k in ("ring_spmv", "block_schwarz"):
        path_launches[k] = launches[k]
    runs = {dtype: [m, m.initial_state()] for dtype, m in big.items()}
    for dtype, run in runs.items():
        _, run[1], _ = run_soufflet(2, model=run[0], state=run[1],
                                    verbose=False)
    for _ in range(2):
        for dtype, run in runs.items():
            mdl, st = run
            n, its = 20, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                _, st, _ = run_soufflet(1, model=mdl, state=st, verbose=False)
                its += mdl.ssh_iters
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run[1] = st
            if not torch.isfinite(st.eta).all():
                fail("phase 8: eta is not finite")
            say(f"phase 8 throughput {str(dtype).replace('torch.', '')}: "
                f"{n / wall:.3f} steps/s, {big_wet * n / wall:.6e} wet "
                f"node-levels/s ({big_wet} wet node-levels; "
                f"{its / n:.1f} CG iterations/step; {card})")

    for dtype, run in runs.items():
        profile_steps("phase 8", run[0], run[1], 3, card)

    # phase 9 ------------------------------------------------------------
    dense_max = dense_max_saved = port_model.DENSE_SSH_MAX_NODES
    port_model.DENSE_SSH_MAX_NODES = 0
    try:
        cg_gpu = setup_soufflet_model(device=dev, which_ale="zstar")
        cg_cpu = setup_soufflet_model(device="cpu", which_ale="zstar")
    finally:
        port_model.DENSE_SSH_MAX_NODES = dense_max
    _, s_gpu, _ = run_soufflet(5, model=cg_gpu, verbose=False)
    _, s_cpu, _ = run_soufflet(5, model=cg_cpu, verbose=False)
    say(f"phase 9 CG iterations of the 5th step: card {cg_gpu.ssh_iters}, "
        f"cpu {cg_cpu.ssh_iters}")
    for name in ("u", "v", "eta", "hbar", "d_eta", "tr", "hnode"):
        ref = getattr(s_cpu, name)
        rel = max_abs(getattr(s_gpu, name).cpu(), ref) / float(ref.abs().max())
        say(f"phase 9 CG path card vs cpu {name}: {rel:.3e} of max|cpu|")
        if not rel <= 1e-8:
            fail(f"phase 9: {name} card vs CPU {rel:.3e} > 1e-8")

    # phase 10 -----------------------------------------------------------
    ci_kernels = cg_kernels + ("kpp_column",)
    wet = int(gmesh.node_layer_mask.sum())
    for dtype, sec in gm_setup.items():
        say(f"phase 10 setup {str(dtype).replace('torch.', '')}: {sec:.3f} s "
            f"(N={gmesh.n_nodes} ocean nodes, {wet} wet node-levels: mesh "
            f"tables with partial cells, tracer statics, reference density, "
            f"block preconditioner, ALE ring)")
    m64 = gm[torch.float64]
    st, f64, sw64 = globe_ocean_inputs(m64, seed=0)
    kernels.reset_launches()
    iters = []
    t0 = time.perf_counter()
    for _ in range(20):
        st = run_pi_ocean(m64, st, f64, sw64, 1)
        iters.append(m64.ssh_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in ci_kernels}
    say(f"phase 10 CI ocean 20 steps float64: {wall:.3f} s, CG iterations "
        f"per step {iters}, launches {launches}")
    check_globe("phase 10", m64, st, launches)
    path_launches.update(launches)
    # launches per step of the CI ocean; the CG kernels also per iteration
    per_step = {k: v / 20 for k, v in launches.items()}
    per_cg_iteration = {k: launches[k] / sum(iters)
                        for k in ("ring_spmv", "block_schwarz")}
    say(f"phase 10 launches per step {per_step}, per CG iteration "
        f"{per_cg_iteration}")
    runs = {dtype: [m, run_pi_ocean(m, *gin[dtype], 2)]
            for dtype, m in gm.items()}
    for _ in range(2):
        for dtype in (torch.float32, torch.float64):
            run = runs[dtype]
            mdl, st = run
            n, its = 20, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                st = run_pi_ocean(mdl, st, gin[dtype][1], gin[dtype][2], 1)
                its += mdl.ssh_iters
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run[1] = st
            if not torch.isfinite(st.eta).all():
                fail("phase 10: eta is not finite")
            say(f"phase 10 throughput {str(dtype).replace('torch.', '')}: "
                f"{n / wall:.3f} steps/s, {wet * n / wall:.6e} wet "
                f"node-levels/s ({wet} wet node-levels; "
                f"{its / n:.1f} CG iterations/step; {card})")
    for dtype, (mdl, st) in runs.items():
        _, frc, sw = gin[dtype]
        profile_steps("phase 10", mdl, st, 3, card,
                      run=lambda m, s_, k, frc=frc, sw=sw: run_pi_ocean(
                          m, s_, frc, sw, k),
                      also=("elem_to_node_mean", "fct_bounds",
                            "node_edge_reduce", "index"))

    # phase 11 -----------------------------------------------------------
    small = globe.write_globe(str(Path(__file__).resolve().parent / "build"
                                  / "chip_smoke" / "globe_l3"), level=3)
    for label, limit, w_max_cfl, tol in (
            ("dense", dense_max_saved, 1.0, 1e-9),
            ("CG forced", 0, 1.0, 1e-8),
            ("w split", dense_max_saved, 1e-5, 1e-9)):
        cfg = port_model.pi_config()
        cfg.run.use_ice = False
        cfg.dyn.w_max_cfl = w_max_cfl
        port_model.DENSE_SSH_MAX_NODES = limit
        try:
            on_gpu, _ = setup_pi_model(small, device=dev, cfg=cfg)
            on_cpu, _ = setup_pi_model(small, device="cpu", cfg=cfg)
        finally:
            port_model.DENSE_SSH_MAX_NODES = dense_max_saved
        s_gpu = run_pi_ocean(on_gpu, *globe_ocean_inputs(on_gpu), 5)
        s_cpu = run_pi_ocean(on_cpu, *globe_ocean_inputs(on_cpu), 5)
        w_i = float(s_gpu.w_i.abs().max())
        say(f"phase 11 level-3 globe ({on_cpu.mesh.n_nodes} nodes), {label}: "
            f"CG iterations of the 5th step card {on_gpu.ssh_iters}, cpu "
            f"{on_cpu.ssh_iters}; |w_i|max {w_i:.3e}")
        split = w_max_cfl < 1.0
        if split and not w_i > 0.0:
            fail(f"phase 11: {label}: the w split never acted (|w_i|max 0)")
        for name in ("u", "v", "eta", "hbar", "tr", "w", "Kv", "hnode",
                     "fer_u") + (("w_i",) if split else ()):
            ref = getattr(s_cpu, name)
            rel = max_abs(getattr(s_gpu, name).cpu(), ref) \
                / float(ref.abs().max())
            say(f"phase 11 {label} card vs cpu {name}: {rel:.3e} of max|cpu|")
            if not rel <= tol:
                fail(f"phase 11: {label} {name} card vs CPU {rel:.3e} > {tol}")

    # phase 12 -----------------------------------------------------------
    ice_kernels = ("elem_contrib_to_nodes", "mevp_stress", "mevp_node")
    coupled_kernels = ci_kernels + ice_kernels
    atm64 = gatm[torch.float64]
    sub64 = m64.ice_sub
    step64 = pi_coupled_step_fn(m64, atm64)
    st, ice = pi_initial_state(m64)
    ice0 = ice
    area = gmesh.area[0]
    kernels.reset_launches()
    iters, hbar_expected = [], 0.0
    t0 = time.perf_counter()
    for k in range(20):
        st, ice, oforc = step64(st, ice, k)
        iters.append(m64.ssh_iters)
        # what the water flux handed to the ocean adds to the mean surface
        hbar_expected = hbar_expected - m64.cfg.dt * (
            oforc.water_flux * area).sum() / area.sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in coupled_kernels}
    say(f"phase 12 coupled CI step, 20 steps float64: {wall:.3f} s, CG "
        f"iterations per step {iters}, launches {launches}")
    per_coupled_step = {k: v / 20 for k, v in launches.items()}
    say(f"phase 12 launches per coupled step {per_coupled_step}")
    check_globe("phase 12", m64, st, launches, float(hbar_expected))
    for name in ("u_ice", "v_ice", "m_ice", "a_ice", "m_snow", "sigma11",
                 "sigma12", "sigma22", "t_skin", "net_heat_flux",
                 "fresh_wa_flux"):
        if not torch.isfinite(getattr(ice, name)).all():
            fail(f"phase 12: ice.{name} is not finite")
    info = step_info(st, gmesh, ice)
    outside = int(((ice.a_ice > 0) & ~sub64.node_mask).sum())
    say(f"phase 12 ice after 20 steps: a_ice in [{float(ice.a_ice.min()):.4f}, "
        f"{info['aice_max']:.4f}], nodes with ice {int((ice.a_ice > 0).sum())} "
        f"(at the start {int((ice0.a_ice > 0).sum())}), area "
        f"{info['ice_area']:.6e} m^2, volume {info['ice_volume']:.6e} m^3, "
        f"max m_ice {info['hice_max']:.4f} m, min m_snow "
        f"{float(ice.m_snow.min()):.3e}, max|u_ice| {info['uice_max']:.4f} "
        f"m/s, max|sigma| {float(ice.sigma11.abs().max()):.3e}, nodes with "
        f"ice outside the subdomain {outside}")
    if not (float(ice.a_ice.min()) >= 0.0 and info["aice_max"] <= 1.0
            and float(ice.m_ice.min()) >= 0.0
            and float(ice.m_snow.min()) >= 0.0):
        fail("phase 12: ice concentration, thickness or snow out of range")
    if not info["aice_max"] > 0.5:
        fail("phase 12: no node with a_ice > 0.5")
    uice = max(info["uice_max"], float(ice.v_ice.abs().max()))
    if not 0.0 < uice < 3.0:
        fail(f"phase 12: max|u_ice| {uice} outside (0, 3) m/s")
    if outside or ice_outside_subdomain(ice, m64):
        fail(f"phase 12: ice at {outside} nodes outside the EVP subdomain")
    for k in ("mevp_stress", "mevp_node"):
        if per_coupled_step[k] != m64.cfg.ice.evp_rheol_steps:
            fail(f"phase 12: {k} launched {per_coupled_step[k]} times a "
                 f"step, not {m64.cfg.ice.evp_rheol_steps}")
    step_calls = {"pressure_bv": 1, "tridiag_solve": 4, "kpp_column": 1,
                  "elem_contrib_to_nodes": 6}
    for k, want in step_calls.items():
        if per_coupled_step[k] != want:
            fail(f"phase 12: {k} launched {per_coupled_step[k]} times a "
                 f"step, not {want}")
    for k in ice_kernels:
        path_launches[k] = launches[k]

    cruns = {}
    for dtype, m in gm.items():
        s_, i_ = pi_initial_state(m)
        s_, i_ = run_pi(m, gatm[dtype], s_, i_, 2)
        cruns[dtype] = [m, s_, i_, 2]
    for _ in range(2):
        for dtype in (torch.float32, torch.float64):
            mdl, s_, i_, k0 = cruns[dtype]
            n = 10
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_, i_ = run_pi(mdl, gatm[dtype], s_, i_, n, first_step=k0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cruns[dtype][1:] = [s_, i_, k0 + n]
            if not (torch.isfinite(s_.eta).all()
                    and torch.isfinite(i_.u_ice).all()):
                fail("phase 12: eta or u_ice is not finite")
            say(f"phase 12 throughput {str(dtype).replace('torch.', '')}: "
                f"{n / wall:.3f} coupled steps/s, {wet * n / wall:.6e} wet "
                f"node-levels/s ({wet} wet node-levels; {card})")
    # the 3-step profiles, each dtype's launches a coupled step counted in
    # them (the CG kernels' with the CG iterations of each dtype's steps)
    step_us, launches_dtype = {}, {}
    for dtype, (mdl, s_, i_, k0) in cruns.items():
        tag = str(dtype).replace("torch.", "")
        kernels.reset_launches()
        step_us[tag] = profile_steps(
            "phase 12", mdl, s_, 3, card,
            run=lambda m, st_, k, a=gatm[dtype], i=i_, k0=k0:
            run_pi(m, a, st_, i, k, first_step=k0),
            also=("mevp", "elem_contrib", "elem_to_node_mean", "pressure_bv",
                  "tridiag_solve"))
        launches_dtype[tag] = {k: kernels.LAUNCHES[k] / 3
                               for k in coupled_kernels}
        say(f"phase 12 launches per coupled step {tag} (the profiled 3 "
            f"steps; CG iterations of the last {mdl.ssh_iters}): "
            f"{launches_dtype[tag]}")
        for k, want in step_calls.items():
            if launches_dtype[tag][k] != want:
                fail(f"phase 12: {k} launched {launches_dtype[tag][k]} times "
                     f"a {tag} step, not {want}")
    # device ms a coupled step spends in each kernel: the self device time
    # of its __global__ functions in the 3-step profiles above; None where
    # the profiler kept no event of it
    functions = {k: (f"::{k}_",) for k in coupled_kernels}
    functions["block_schwarz"] = ("::local_solve_kernel<",
                                  "::coarse_solve_kernel<", "::combine_kernel<")
    step_ms = {tag: {k: sum(v for key, v in us.items()
                            if any(f in key for f in functions[k])) / 1e3
                     or None for k in coupled_kernels}
               for tag, us in step_us.items()}
    say(f"phase 12 device ms a coupled step per kernel (profile): {step_ms}")
    per_launch_us = {tag: {k: step_ms[tag][k] / launches_dtype[tag][k] * 1e3
                           for k in ("block_schwarz", "ring_spmv")
                           if step_ms[tag][k] and launches_dtype[tag][k]}
                     for tag in step_ms}
    say(f"phase 12 device us a launch in the profiled steps: {per_launch_us}")
    # the subcycle loop of one step: 120 subcycles with the kernels (as the
    # step runs them) and with mevp_subcycle_plain called directly
    n_sub = m64.cfg.ice.evp_rheol_steps
    for dtype in (torch.float64, torch.float32):
        tab, uv0, sig0, cap = ice_tables[dtype]

        def loop(subcycle, uv=uv0, sig=sig0, tab=tab, cap=cap):
            uv, sig = uv.clone(), sig.clone()
            for _ in range(n_sub):
                uv, sig = subcycle(uv, sig, tab, cap)
            return uv
        k_ms = timed(lambda: loop(evp.mevp_subcycle), reps=5, warmup=1)
        p_ms = timed(lambda: loop(evp.mevp_subcycle_plain), reps=3, warmup=1)
        say(f"phase 12 subcycle loop {str(dtype).replace('torch.', '')}: "
            f"{n_sub} subcycles take {k_ms:.3f} ms a step with the kernels "
            f"({2 * n_sub} launches) and {p_ms:.3f} ms with "
            f"mevp_subcycle_plain ({card})")

    # phase 13 -----------------------------------------------------------
    for label, limit in (("dense", dense_max_saved), ("CG forced", 0)):
        port_model.DENSE_SSH_MAX_NODES = limit
        try:
            on_gpu, atm_gpu = setup_pi_model(small, device=dev)
            on_cpu, atm_cpu = setup_pi_model(small, device="cpu")
        finally:
            port_model.DENSE_SSH_MAX_NODES = dense_max_saved
        kernels.reset_launches()
        s_gpu, i_gpu = run_pi(on_gpu, atm_gpu, *pi_initial_state(on_gpu), 3)
        n_evp = kernels.LAUNCHES["mevp_node"]
        s_cpu, i_cpu = run_pi(on_cpu, atm_cpu, *pi_initial_state(on_cpu), 3)
        say(f"phase 13 level-3 globe ({on_cpu.mesh.n_nodes} nodes, subdomain "
            f"{on_cpu.ice_sub.n_nodes}), {label}: CG iterations of the 3rd "
            f"step card {on_gpu.ssh_iters}, cpu {on_cpu.ssh_iters}; nodes "
            f"with ice {int((i_cpu.a_ice > 0).sum())}, max|u_ice| "
            f"{float(i_cpu.u_ice.abs().max()):.4e}, mevp_node launches on "
            f"the card {n_evp}")
        if kernels.LAUNCHES["mevp_node"] != n_evp or n_evp != 3 * n_sub:
            fail("phase 13: the CPU path launched a kernel, or the card's "
                 "path did not")
        if not (float(i_cpu.a_ice.max()) > 0.5
                and float(i_cpu.u_ice.abs().max()) > 0.0
                and float(i_cpu.sigma11.abs().max()) > 0.0):
            fail(f"phase 13: {label}: no moving ice under stress")
        for obj_gpu, obj_cpu, names in (
                (s_gpu, s_cpu, ("u", "v", "eta", "hbar", "tr", "w", "Kv",
                                "hnode", "fer_u")),
                (i_gpu, i_cpu, ("u_ice", "v_ice", "m_ice", "a_ice", "m_snow",
                                "sigma11", "sigma12", "sigma22", "t_skin",
                                "net_heat_flux", "fresh_wa_flux"))):
            for name in names:
                ref = getattr(obj_cpu, name)
                rel = max_abs(getattr(obj_gpu, name).cpu(), ref) \
                    / float(ref.abs().max())
                say(f"phase 13 {label} card vs cpu {name}: {rel:.3e} of "
                    f"max|cpu|")
                if not rel <= 1e-8:
                    fail(f"phase 13: {label} {name} card vs CPU {rel:.3e} "
                         f"> 1e-8")

    # result -------------------------------------------------------------
    sources = {"node_edge_reduce": "fesom2_tpu/core/ops.py:154",
               "elem_to_node_mean": "fesom2_tpu/core/ops.py:328",
               "tridiag_solve": "fesom2_tpu/core/ops.py:389",
               "fct_bounds": "fesom2_tpu/core/tracers.py:584",
               "ring_spmv": "fesom2_tpu/core/ssh.py:209",
               "block_schwarz": "fesom2_tpu/core/ssh.py:429",
               "window_gather": "scripts/gather_cost_model.py:115",
               "onehot_gather": "scripts/gather_cost_model.py:148",
               "pressure_bv": "fesom2_tpu/core/eos.py:88",
               "kpp_column": "fesom2_tpu/core/mixing/kpp.py:157",
               "elem_contrib_to_nodes": "fesom2_tpu/core/ops.py:283",
               "mevp_stress": "fesom2_tpu/ice/evp.py:85",
               "mevp_node": "fesom2_tpu/ice/evp.py:106"}
    # tridiag_solve's four calls a coupled step priced at phase 3's times
    # of their shapes (momentum on elements, gm_redi's nl rows, the tracers'
    # two solves), beside the profile's time
    L7, N7, E7 = gmesh.nl - 1, gmesh.n_nodes, gmesh.n_elems
    tri_calls = {(L7, N7): 2, (L7, E7): 1, (L7 + 1, N7): 1}
    shapes = summary["tridiag_solve"]["shapes"]
    tri_step = {}
    for tag in ("float64", "float32"):
        dev = [shapes[f"{tag} globe a,b,c {[R, X]} d {[2, R, X]}"][
            "device_ms"] for R, X in tri_calls]
        if all(v is not None for v in dev):
            tri_step[tag] = sum(n * v for n, v in zip(tri_calls.values(),
                                                      dev))
    say(f"tridiag_solve device ms a coupled step by phase 3's shapes (2 x "
        f"[2, {L7}, {N7}], [2, {L7}, {E7}], [2, {L7 + 1}, {N7}]): {tri_step}")
    # elem_contrib_to_nodes' six calls a coupled step priced the same way
    ecn_step = {}
    for tag in ("float64", "float32"):
        rows = [r for key, r in summary["elem_contrib_to_nodes"][
            "shapes"].items() if key.startswith(tag)]
        if all(r["device_ms"] is not None for r in rows):
            ecn_step[tag] = sum(r["launches_per_coupled_step"]
                                * r["device_ms"] for r in rows)
    say(f"elem_contrib_to_nodes device ms a coupled step by phase 3's "
        f"shapes: {ecn_step}")
    step_rows = {"tridiag_solve": tri_step, "elem_contrib_to_nodes": ecn_step}
    say(json.dumps({"numbering_device_us": numbering_us}))
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": "fesom2_tpu_torch/csrc/"
         + kernels.SOURCES.get(k, f"{k}.cu"),
         "replaces": sources[k], "launches": path_launches[k],
         "max_abs_err": summary[k]["max_abs_err"],
         "ms": summary[k]["ms"], "plain_ms": summary[k]["plain_ms"],
         "bound_ms": summary[k]["bound_ms"],
         "bound_by": summary[k]["bound_by"],
         "method_bound_ms": summary[k].get("method_bound_ms"),
         "library_batch_ms": summary[k].get("library_batch_ms"),
         "library_ms": summary[k]["library_ms"],
         "device_ms": summary[k]["device_ms"],
         "library_device_ms": summary[k]["library_device_ms"],
         "launches_per_step": per_step.get(k),
         "launches_per_coupled_step": per_coupled_step.get(k),
         "launches_per_coupled_step_f32": launches_dtype["float32"].get(k),
         "launches_per_cg_iteration": per_cg_iteration.get(k),
         "step_device_ms": step_ms["float64"].get(k),
         "step_device_ms_f32": step_ms["float32"].get(k),
         **({"shapes": summary[k]["shapes"]} if "shapes" in summary[k]
            else {}),
         **({"shapes_step_device_ms": step_rows[k]} if k in step_rows
            else {})}
        for k in kernels.KERNELS]}))
    say(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
