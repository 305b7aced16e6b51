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
   tridiag_solve, ring_spmv, elem_contrib_to_nodes, mevp_subcycles and
   the probe kernels bitwise; a
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
   timed once on each numbering; ``onehot_gather``'s method bound is
   that of three bf16 products on the tensor cores, and ``torch.bmm`` is
   also timed over 50 calls between one pair of events; the sea ice's
   two kernels on the level-7 globe after one coupled step:
   ``elem_contrib_to_nodes`` at the six shapes the coupled step launches
   (the subdomain's two rows element-major; on the globe six rows
   vertex-major, nine, six, two by three and three rows element-major),
   each bitwise, with its call a step and their sum priced at these times
   (library call: a CSR product over the same incidence), and
   ``mevp_subcycles`` on the subdomain's tables, the step's 120 subcycles
   in one launch, bitwise against 120 of ``mevp_subcycle_plain`` and timed
   beside its bound, then held bit for bit after 1, 8 and 120 subcycles,
   with its launch plan and its latency floor (an empty cooperative kernel
   on the same grid crossing the same grid barriers); the same for the
   kernel's standard- and adaptive-EVP instantiations (``evp_subcycles``,
   ``aevp_subcycles``) on the same state's subdomain tables, each against
   its plain loop (no library call computes either); ``ring_spmv``
   bitwise at both rings (the channel's [8, N], the globe's [10, N]);
   the shapes the ocean dynamics menus add on the level-7 globe:
   ``ring_spmv`` bitwise on the fast configuration's static linfs ring,
   ``elem_contrib_to_nodes`` bitwise at [L, E, 3] (the vector-invariant
   momentum's kinetic energy) and ``elem_to_node_mean`` on one [L, E]
   field with and without the level mask (the viscosity menu's
   smoothing), each with its bound and library call; the kernels the
   ice-shelf cavities change or feed, on the level-7 globe under the
   shelf of ``globe.shelf_draft`` (a 250 m draft south of 62S; its state
   after one coupled step): ``fct_bounds`` and ``elem_to_node_mean``
   bitwise on its cluster tables (with the count of neighbour entries
   split into two runs), ``kpp_column`` (bitwise in float64) and
   ``pressure_bv``
   (columns whose top lies below the surface), each with its bound and
   library call and whether it is bitwise, beside the same kernels'
   times on the shelf-free globe; the Icepack step's kernels on the
   inputs its second coupled step hands them on the level-7 globe
   (``ice.icepack.driver.recording_kernel_inputs``): ``bl99_temperature_
   solve`` on the [5, 114033] columns (1e-12 / 1e-5, the same sweep count
   in float64; a float32 sweep count or melting flag that differs is
   reported), ``itd_remap``'s two calls (the remap with the rebin, the
   rebin alone; bitwise, with their launch plans) and ``mevp_subcycles``
   on the whole mesh with the strength field (bitwise, its plan and the
   latency floor of its grid barriers there), each with its bound and no
   library call;
   ``dens_moc_bin`` (the density-space MOC binning) on the interface
   densities and layers of the level-7 globe after one coupled step,
   [5, 89, 225854], each of its five outputs within 1e-12 / 1e-5 of
   max|plain| (the plain chain over chunks of elements), its bound from
   this state's active layers and class runs, the histogram of the
   elements' class spans and its launch plan, no library call;
4. 20 float64 steps of the soufflet channel (2,875 nodes, 40 layers,
   linfs, dense SSH) through ``run.run_soufflet``, with sanity bounds,
   linfs volume conservation and a launch count above 0 for every kernel
   of that path;
5. 5 float64 steps on the card (kernels) against 5 on the CPU (plain
   versions) from the same state, within 1e-9 of max|CPU|;
6. setup seconds, then throughput of 30 float32 and 30 float64 steps
   after 2 warm-up steps, one dtype after the other, and a profile of 5
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
   one after the other);
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
    float64 (20 steps each, one after the other), the launches of
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
    the subdomain, and every kernel of the path launched
    (``mevp_subcycles``, ``pressure_bv`` and ``kpp_column`` once a step,
    ``tridiag_solve`` four times and ``elem_contrib_to_nodes`` six times;
    the retired pair ``mevp_stress`` and ``mevp_node`` no longer a kernel);
    then throughput in float32 and float64 (``run_pi``, and a bare loop
    of the step after it: the cost of ``run_pi``'s blowup scan, which is
    also timed alone, host ms and device us a scan), a 3-step profile per
    dtype with the launches a step of each kernel counted in it (the same
    gates, ``mevp_subcycles`` once a step in both dtypes), the device ms a
    step under each ``record_function`` span (``span_device_ms``) and the CG
    kernels' device us a launch in the step (``ring_spmv``,
    ``block_schwarz``), and the subcycle loop's wall and device
    milliseconds a step (one launch; information);
13. the coupled step card against CPU on the level-3 globe, 3 float64
    steps, dense and CG forced: every ocean and ice field within 1e-8 of
    max|CPU| (the card's exp, pow and log differ from the CPU's in the
    last bits, and 120 subcycles, the Newton iterations of the ice
    surface temperature and three ocean steps carry them on);
14. the fast configuration's coupled step at full width
    (``setup_pi_model(parity="fast")``: ``bench.py``'s
    ``BENCH_PARITY=fast``, linfs + PP on full cells, no GM/Redi, the same
    ice) on the level-7 globe: 20 float64 steps gated on the ocean bounds
    of phase 10 with the area-mean hbar within 1e-6 m of 0 (under linfs
    the freshwater flux is a virtual salt flux), the ice bounds of phase
    12, every kernel of the path launched and ``kpp_column`` never
    (``pressure_bv`` and ``mevp_subcycles`` once a step,
    ``elem_contrib_to_nodes`` six times); throughput in float32 and
    float64 with CG iterations a step, a 3-step profile per dtype with its
    launches a step of each kernel (the same gates), its device ms a step
    per kernel and per span;
15. the ocean dynamics menus card against CPU, 3 float64 steps each,
    every field within 1e-8 of max|CPU| and no kernel launched on the
    CPU path: on the level-3 globe the fast coupled step (dense and CG
    forced), zlevel, ``use_floatice`` under zstar (coupled),
    ``mom_adv=3``, ``visc_option`` 1-4 and 6-8 and the PGF forms
    (cubicspline, easypgf under zstar; nemo, shchepetkin, cubicspline,
    easypgf under linfs with partial cells), the CI ocean where the ice
    is not needed; nemo and cubicspline on the linfs channel (full cells);
16. the CI coupled step under the ice shelf at full width
    (``setup_pi_model(cavity_depth=globe.shelf_draft(...))`` on the
    level-7 globe, 47 layers, CG): 10 float64 steps gated on the bounds of
    phase 12 (the area-mean hbar over the areas of each column's top row,
    ``areasvol`` at ``ulevels - 1``), no sea ice under the shelf, some melt
    heat flux there, T, S, density, pressure, u and v exactly 0 above each
    column's top, the launches a step of phase 12 and every kernel of
    the path launched; the cavity nodes and elements; throughput over 10
    steps in each dtype, a 3-step profile per dtype with the device ms a
    step per kernel and per span (``step.cavity`` among them);
17. card against CPU, 3 float64 coupled steps each, every field within
    1e-8 of max|CPU| (Kv on the interfaces each column has) and no kernel
    launched on the CPU path: the shelf on the level-3 globe (the CI step
    dense and with CG forced; the fast configuration with cavity partial
    cells under 'sergey', 'shchepetkin' and 'easypgf'), and the CI step
    on the level-2 globe with ``n_refine=1``;
18. the level-6 globe refined once (``setup_pi_model(n_refine=1)``:
    28,795 ocean nodes become about 114,000, numbered as the subdivision
    leaves them): 5 float64 coupled steps with phase 12's gates, then
    coupled steps a second in both dtypes, and the device us of
    ``node_edge_reduce``, ``elem_to_node_mean`` and ``fct_bounds`` on its
    numbering beside phase 3's on both numberings of the level-7 globe
    (information);
19. the column-physics menus on the CI coupled step at full width:
    ``cvmix_TKE+cvmix_IDEMIX``, the salt plume and six tracers (T, S, the
    rain tracer 101, the strait tracers 301-303) on the level-7 globe
    with phase 12's tables and atmosphere: 10 float64 steps gated on
    phase 12's ocean and ice bounds, tke >= 0 and finite on every active
    interface, iwe >= 0, Kv and Av finite and >= 0, a rain-water
    inventory that grows under positive ``prec_rain``, each strait region
    that holds nodes held at 1, ``kpp_column`` never launched and every
    other kernel of phase 12 launched (``tridiag_solve`` 6 times a step:
    TKE's and IDEMIX's systems beside the CI step's four); the same 10
    steps with the Redi terms off, where the advection (FCT) and the
    implicit vertical diffusion alone move the tracers, gated on 101 >=
    -1e-9 and 301-303 in [-1e-9, 1 + 1e-9] (the explicit Redi fluxes are
    not limited, in the JAX package either); coupled steps a second in
    both dtypes, a 3-step profile per dtype with the device ms a step per
    span and the device ms, host ms and kernels a step of
    ``step.mixing.tke``, ``step.mixing.idemix`` and ``step.mixing``, and
    the peak memory allocated;
20. card against CPU, 3 float64 steps each, every field within 1e-8 of
    max|CPU| and no kernel launched on the CPU path, on the level-3
    globe (the ocean alone unless the case needs the ice): each
    ``tra_adv_hor`` (UPW1, MUSCL, MFCT) and ``tra_adv_ver`` (UPW1, CDIFF,
    PPM), ``tra_adv_lim='NONE'`` with and without the w split,
    ``i_vert_visc`` and ``i_vert_diff`` off, each ``mix_scheme``
    (cvmix_PP, cvmix_TKE, cvmix_IDEMIX alone, cvmix_KPP,
    KPP+cvmix_TIDAL, PP+cvmix_DDIFF+cvmix_CONV) and TKE+IDEMIX with SPP
    and six tracers on the coupled step; on the soufflet channel a toy
    channel of another name and sea ice on the channel
    (``coupled_step_fn``).  Phase 3 also times the shapes these menus
    add: ``tridiag_solve`` [48, N] with one right-hand side and [6, 47,
    N], ``fct_bounds`` [6, 47, N].

21. standard (``whichEVP=0``) and adaptive (2) EVP on the CI coupled step
    at full width (phase 12's tables and atmosphere, the subdomain
    poleward of 40 degrees): 10 float64 steps each gated on phase 12's
    ocean and ice bounds, the rheology's kernel once a step and
    ``mevp_subcycles`` never, under aEVP ``alpha_aevp`` and ``beta_aevp``
    finite and >= 50; coupled steps/s in both dtypes and a 3-step profile
    per dtype with ``step.ice.evp``'s device and host ms a step;
22. forcing and initial state from files at full width: NetCDF3 files
    written from a seed (``forcing/synthetic.py``: the NCEP test-set
    layout on the T62 grid's 192 x 94, latitudes descending, 8 six-hourly
    wind records, 2 of radiation and precipitation, CF units; a WOA18
    climatology of 72 x 36 columns to 7,000 m with missing values) read by
    ``setup_pi_model(forcing_path=...)`` and ``pi_initial_state(model,
    forcing_path=...)`` with ``use_global_tides``, ``l_mslp`` and
    ``clim_relax`` on and a ``relax2clim`` sponge poleward of 60 degrees:
    10 float64 steps gated on phase 12's bounds, ``ssh_gp`` finite and not
    zero; setup seconds split into loading and building, coupled steps/s
    and a 3-step profile with the spans;
23. card against CPU on the level-3 globe, 3 float64 coupled steps each,
    every field within 1e-8 of max|CPU| and no kernel launched on the CPU
    path: ``whichEVP`` 0 and 2 on the subdomain and on the whole mesh, the
    tides with ``l_mslp``, the relaxation sponge, forcing and initial
    state from phase 22's files; and one ``ice_timestep_cpl`` (the
    coupled-mode thermodynamics) on seeded ``CoupledAtmFluxes``.

24. the Icepack CI coupled step at full width (phase 12's tables and
    atmosphere, ``cfg.run.use_icepack`` with the default IcepackConfig:
    5 categories, 4 ice and 4 snow layers; its mEVP on the whole mesh):
    10 gated steps in each dtype (every field of the ocean, the ice and
    the IcepackState finite; phase 12's ocean bounds with the area-mean
    hbar against the summed water flux; aicen in [0, 1] with its category
    sum at most 1 + 1e-12 in float64, 1 + 2^-22 in float32 (its rounding);
    vicen, vsnon >= 0; some a_ice > 0.5; every kernel of the path
    launched, ``bl99_temperature_solve`` once a step, ``itd_remap`` twice,
    each call bit-equal to ``itd_remap_plain`` on the step's own inputs,
    ``mevp_subcycles`` once), the BL99 sweeps a step, the peak memory,
    Icepack coupled steps/s beside phase 12's and a 3-step profile with
    the device and host ms a step of ``step.icepack.thermo1``,
    ``.thermo2``, ``.dynamics``, ``.advection``, ``.ridging`` and
    ``.aggregate``, with the kernels a step under each and how many of
    them are torch.cat / torch.stack copies;
25. card against CPU on the level-3 globe, 3 float64 Icepack coupled
    steps each (4 with ``ice_ave_steps = 2``), every field of the ocean,
    the ice and the IcepackState within 1e-8 of max|CPU|, no kernel on the
    CPU path, each ``itd_remap`` call on the card bit-equal to its plain
    version on the same inputs: the default IcepackConfig, ponds + age +
    first-year + level ice, dEdd, the floe-size distribution, the
    biogeochemistry and ``ice_ave_steps = 2``.

26. the run's output path at full width (phase 12's tables and
    atmosphere with ``ldiag_DVD``, ``ldiag_dMOC``, ``ldiag_energy``,
    ``lcurt_stress_surf``, ``ldiag_curl_vel3`` and ``ldiag_salt3D`` on):
    ``run.run_pi`` with a result directory under ``build/chip_smoke/``,
    the default ocean and ice streams and the ``dvd_*``, ``std_dens_*``,
    ``curl_u`` and ``density_flux_e`` streams hourly (a flush every 4
    steps), restarts every 5 steps; 10 float64 steps gated on phase 12's
    ocean and ice bounds (the area-mean hbar against the run's mean water
    flux, read back from its own ``fw`` stream), ``dvd_h`` and ``dvd_v``
    finite, ``std_dens_VOL`` summed equal to the ocean volume (1e-10),
    ``std_dens_W`` summed over the classes equal to each element's active
    layers (1e-12), ``std_dens_UDZ`` summed equal to the summed u helem
    (1e-8), every stream file, ``fesom.mesh.diag.nc``, ``fesom.clock``
    and ``restart.nc`` written, ``sst``'s and ``a_ice``'s two hourly
    records equal to means the phase accumulates over the same steps
    taken again (1e-12), a run resumed from a step-5 restart to step 10
    equal to the unbroken one (bitwise, else the fields that differ,
    within 1e-12), a state with a NaN in eta raising with step 1 and
    leaving ``blowup.nc``, ``dens_moc_bin`` once a step; coupled steps/s
    in both dtypes with all of it on beside phase 12's, the host ms a
    step of the output (``update_means`` and the flushes) and of
    ``update_means`` alone, a 3-step profile per dtype with the device ms
    a step of ``step.tracers.dvd``, ``step.output`` and ``dens_moc_bin``,
    the peak memory;
27. card against CPU on the level-3 globe, 3 float64 coupled steps
    through ``run_pi`` with every diagnostic flag on and the streams
    flushed at the end: ``dvd_h``, ``dvd_v`` and every output of
    ``compute_diagnostics`` and every stream's mean within 1e-8 of
    max|CPU|, the card's restart read on the CPU equal to the card's state
    bit for bit, no kernel launched on the CPU path.
28. the CI coupled step across ranks (``parallel/dist.py``): phase 12's
    models under ``prepare_dist_model`` (matrix-free Jacobi CG, EVP on the
    whole mesh) take 3 float64 and 3 float32 steps on the card; the same
    steps over 2 spawned ranks of a gloo group sharing the card (each with
    its local mesh of the level-7 globe, the local block-Schwarz CG, the
    per-rank ice subdomain; the exchanges through pinned host memory),
    both dtypes in one start of the ranks, gathered and held against them
    within ``tests/test_dist.py``'s tolerances in float64 (eta, tr, w
    1e-7, u 1e-6, hnode 1e-9, the ice 1e-7) and 1e-2 in float32; every
    halo slot equal to its owner's, the same CG iterations on both
    ranks, no blowup, and in each rank each step every kernel of the
    path launched with ``mevp_subcycles`` 120 times (a launch a subcycle)
    and ``ring_spmv`` never; printed per rank: steps/s beside one
    device's, the exchanges' calls, bytes and host ms a step by kind, a
    profiled step's device ms and those under the ``dist.*`` spans, the
    launches a step, the ranks' start-up; nccl with a card a rank where
    there are two cards; the default partition's (bisection with
    Kernighan-Lin sweeps) edge cut and forward-exchange slots beside the
    plain bisection's; the contiguous-block placement of
    ``parallel/sharding.py`` (node i on rank i // (N/2)) over 2 gloo ranks:
    2 CI coupled steps on the level-3 globe padded to 2 against one device
    on the real entities (the same tolerances), the halo consistent;
29. ``mkrun`` on the card: the base namelists of the CI configuration and
    a ``setup.yml`` with six streams written under ``build/chip_smoke/
    mkrun`` (the paths file maps the mesh id to the level-7 globe; the
    forcing is built in code), ``run_setup`` 2 steps, its field means
    equal to those of ``run_pi`` on the same configuration (1e-12), and
    the golden verdicts (within 5 % passes, 20 % off fails).
30. post-processing on phase 26's level-7 output directory (run before
    phase 28, as are 31 and 32): ``post.load_mesh`` equal to the model's
    mesh tables; ``fpost.run_fpost`` on a 2-degree grid, grid info, TS3,
    UVnorm and the MOC from w, one product a call, each product finite
    where the grid's wet mask is set; ``moc_dens`` from the
    ``std_dens_VDZ`` stream; both streamfunctions finite and within 1e-10
    of the same latitude sums taken on the card (``index_add_``), their
    max|psi| reported (10 steps from rest: an adjustment, not a spun-up
    circulation, so no bound in Sv holds); ``write_goldens`` then
    ``fcheck`` on the same run passes and the goldens 1 % off fail; the
    host seconds of each product; ``utils.support``'s ``smooth_nod`` (3
    passes of sst) and ``smooth_elem`` (2 of u) on the card, 5 launches of
    ``elem_to_node_mean``, within 1e-12 of the same passes through its
    plain version;
31. the coupler at full width: 4 coupled-mode ice steps
    (``ice_timestep_cpl``, the ocean held) on the level-7 globe, ``collect``
    every step, ``send`` / ``recv`` before the first step and every 2
    steps over ``SocketTransport`` to an ``OasisEndpoint`` whose
    atmosphere thread posts seeded ECHAM fields, ``force_flux_consv`` on
    heat_oce (its area integral equal to the atmosphere's net to 1e-12),
    finite ice, ``mevp_subcycles`` once a step; the host ms of each
    coupling event; the same 4 steps on the level-3 globe card against
    CPU (1e-8);
32. ``utils.profiling.profile_pi_phases`` on the level-7 CI step in
    float64 and float32 (n=5): the JAX package's keys, finite values >= 0,
    every kernel of the coupled step launched; printed beside phase 12's
    device ms a step per span.

Any failure exits non-zero before the last line.  Before it come one
JSON line with the gather kernels' device times on both numberings, one
with the device ms a step per span of the coupled steps, each menu
case's worst field and phase 19's rates, memory, mixing spans and
passive-tracer bounds, phase 26's rates and output costs, phase 27's
worst fields and phases 28's to 32's reports, one
with every kernel's launches, error, times, bound and library time (with
the device ms a coupled step spends in it, from phase 12's, 14's and
16's and 19's profiles, its launches a float64 and a float32 coupled
step of the configurations, and the times of every
shape of tridiag_solve, elem_contrib_to_nodes, block_schwarz, ring_spmv
and kpp_column, the first two's calls a step also priced at those times), the
seconds the run took and the card; the last line is
``{"ok": true, "device": {...}}``.  It needs one card and exits non-zero
where CUDA is not available.
"""
import bisect
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path


PHASES = []     # (phase, seconds from the start of main) as each begins


def phase_start(phase: int, t_start: float):
    """Say when a phase begins, and keep it for the phases' wall seconds."""
    t = time.perf_counter() - t_start
    PHASES.append((phase, t))
    say(f"phase {phase} starts at {t:.1f} s")


def phase_walls(total: float) -> dict:
    """{phase: wall seconds} from when each began to when the next did (in
    the order they ran), the last to ``total``."""
    ends = [t for _, t in PHASES[1:]] + [total]
    return {str(p): round(e - t, 1) for (p, t), e in zip(PHASES, ends)}


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


def span_device_ms(prof, n: int, counts=None, named=None) -> dict:
    """Device ms a step of the CUDA kernels under each ``step.*`` span: a
    kernel belongs to the span whose device-side range (the profiler's
    copy of the ``record_function`` span on the card's timeline) holds its
    start; kernels outside every span count as "outside spans".  With a
    dict ``counts``, also fills it with the kernels a step under each; with
    a dict ``named`` of {name fragment: {}}, fills each inner dict with the
    kernels a step under each span whose name holds the fragment."""
    from torch.autograd import DeviceType
    spans, kern = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        (spans if e.name.startswith("step.") else kern).append(e)
    spans.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    out = {}
    for k in kern:
        # the innermost span that holds the kernel's start: the latest
        # started of those that hold it (spans nest or are disjoint)
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        name = "outside spans"
        while i >= 0:
            if k.time_range.start < spans[i].time_range.end:
                name = spans[i].name
                break
            i -= 1
        out[name] = out.get(name, 0.0) + k.time_range.elapsed_us()
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1 / n
        for frag, per_span in (named or {}).items():
            if frag in k.name:
                per_span[name] = per_span.get(name, 0) + 1 / n
    return {k: v / 1e3 / n for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def profile_steps(phase: str, model, state, n: int, card: str, run=None,
                  also=(), spans=None, host_spans=None, span_counts=None,
                  span_named=None):
    """Profile n steps (``run(model, state, n)``, by default
    ``run_soufflet``): wall and device kernel time, the busy share, the
    kernels per step, the 12 costliest kernels, every kernel whose name
    holds one of ``also``, and the host time of each ``step.*`` span
    (information, not a gate).  Returns the device us per step of each
    CUDA kernel by name; with a dict ``spans``, also fills it with the
    device ms a step under each span (``span_device_ms``); with dicts
    ``host_spans`` and ``span_counts``, with the host ms a step of each
    span and the kernels a step under it; with ``span_named``, the
    kernels a step under each span by name fragment (``span_device_ms``'s
    ``named``)."""
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
        if host_spans is not None:
            host_spans[e.key] = e.cpu_time_total / 1e3 / n
    if spans is not None:
        spans.update(span_device_ms(prof, n, span_counts, span_named))
        total = sum(spans.values())
        say(f"{phase} device ms a step per span "
            f"{str(model.dtype).replace('torch.', '')} (kernels {total:.3f} "
            f"ms a step; {card}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
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
                hbar_expected: float = 0.0, area=None):
    """The global ocean's bounds: every field finite, |u| < 3 m/s, T in
    [-3, 35] C, area-mean hbar within 1e-6 m of ``hbar_expected`` (0 where
    the water flux has zero mean; the coupled step's fluxes add up to a
    known mean) and a launch count above 0 for every kernel of the path.
    The mean is over ``area`` [N] (default the surface areas; under ice-
    shelf cavities the areas of each column's top row)."""
    import torch
    m = model.mesh
    for name in ("u", "v", "eta", "hbar", "tr", "w", "Kv", "Av", "hnode"):
        if not torch.isfinite(getattr(state, name)).all():
            fail(f"{phase}: {name} is not finite")
    umax = float(state.u.abs().max())
    T = state.tr[0][m.node_layer_mask]
    a = m.area[0] if area is None else area
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


def check_ice(phase: str, model, state, ice, ice0, n_steps: int = 20):
    """The coupled step's ice bounds after its ``n_steps`` steps: every ice field
    finite, 0 <= a_ice <= 1, m_ice and m_snow >= 0, some a_ice > 0.5,
    0 < max|u_ice| < 3 m/s and no ice outside the EVP subdomain."""
    import torch
    from fesom2_tpu_torch.run import ice_outside_subdomain, step_info
    for name in ("u_ice", "v_ice", "m_ice", "a_ice", "m_snow", "sigma11",
                 "sigma12", "sigma22", "t_skin", "net_heat_flux",
                 "fresh_wa_flux"):
        if not torch.isfinite(getattr(ice, name)).all():
            fail(f"{phase}: ice.{name} is not finite")
    info = step_info(state, model.mesh, ice)
    outside = int(((ice.a_ice > 0) & ~model.ice_sub.node_mask).sum())
    say(f"{phase} ice after {n_steps} steps: a_ice in [{float(ice.a_ice.min()):.4f}, "
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
        fail(f"{phase}: ice concentration, thickness or snow out of range")
    if not info["aice_max"] > 0.5:
        fail(f"{phase}: no node with a_ice > 0.5")
    uice = max(info["uice_max"], float(ice.v_ice.abs().max()))
    if not 0.0 < uice < 3.0:
        fail(f"{phase}: max|u_ice| {uice} outside (0, 3) m/s")
    if outside or ice_outside_subdomain(ice, model):
        fail(f"{phase}: ice at {outside} nodes outside the EVP subdomain")


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


def split_entries(ct) -> int:
    """Entries of the fct_bounds neighbour table beyond one per (node,
    neighbour) pair: a pair whose shared wet levels are not one run (beside
    an ice shelf) has an entry per run."""
    import torch
    w = ct.fct_slot.long() & 0xFFFFFFFF                 # [M, N]
    local, lo, hi = w & 0xFFFF, (w >> 16) & 0xFF, w >> 24
    node = torch.arange(w.shape[1], device=w.device)[None].expand_as(w)
    keys = (node * 65536 + local)[lo < hi]
    return int(keys.numel() - torch.unique(keys).numel())


# the kernels of the distributed CI coupled step (ring_spmv is not on it:
# the distributed solve is matrix-free)
DIST_PATH_KERNELS = ("node_edge_reduce", "elem_to_node_mean", "tridiag_solve",
                     "fct_bounds", "pressure_bv", "kpp_column",
                     "elem_contrib_to_nodes", "block_schwarz",
                     "mevp_subcycles")


def _pad_zeros(sizes):
    """Pad every tensor leaf whose last axis is a mesh size (a key of
    ``sizes``) with zeros to the padded size."""
    import torch

    def pad(x):
        if isinstance(x, torch.Tensor) and x.ndim and x.shape[-1] in sizes:
            n = sizes[x.shape[-1]] - x.shape[-1]
            return torch.cat([x, x.new_zeros(x.shape[:-1] + (n,))], -1)
        return x
    return lambda o: dataclasses.replace(o, **{
        f.name: pad(getattr(o, f.name)) for f in dataclasses.fields(o)}) \
        if dataclasses.is_dataclass(o) else pad(o)


def phase28_block(small: str, card: str) -> dict:
    """The contiguous-block placement of ``parallel/sharding.py`` over 2
    gloo ranks on the card: 2 float64 CI coupled steps on the level-3
    globe padded to 2 (the unpadded model's initial state, atmosphere and
    relaxation fields padded with zeros), against the one-device step of
    ``prepare_dist_model`` on the real entities."""
    import numpy as np
    from fesom2_tpu_torch.model import (pi_coupled_step_fn,
                                        pi_initial_state, setup_pi_model)
    from fesom2_tpu_torch.parallel import dist, sharding
    S = 2
    m1, atm1 = setup_pi_model(small, device="cuda")
    s1, i1 = pi_initial_state(m1)
    m2, _ = setup_pi_model(small, device="cuda", pad_to=S)
    a, b = m1.mesh, m2.mesh
    real = {b.n_nodes: a.n_nodes, b.n_elems: a.n_elems}
    pad = _pad_zeros({a.n_nodes: b.n_nodes, a.n_elems: b.n_elems,
                      a.n_edges: b.n_edges})
    s0, i0, atm = pad(s1), pad(i1), pad(atm1)
    for k in ("Ssurf", "Tclim", "Sclim", "relax2clim"):
        setattr(m2, k, pad(getattr(m1, k)))
    dist.prepare_dist_model(m2)
    step = pi_coupled_step_fn(m2, atm)
    s, i = s0, i0
    for k in range(2):
        s, i, _ = step(s, i, k)
    layout = sharding.block_layout(m2, S)
    t0 = time.perf_counter()
    res = dist.run_coupled_steps([dict(model=m2, atm=atm, state=s0, ice=i0,
                                       n_steps=2)], layout, backend="gloo",
                                 device="cuda")[0]
    wall = time.perf_counter() - t0
    errs = {}
    for obj_r, obj, names in ((s, res["state"], dist.OCEAN_TOL),
                              (i, res["ice"], dist.ICE_TOL)):
        for name, tol in names:
            x = getattr(obj_r, name).cpu().numpy()
            y = getattr(obj, name).cpu().numpy()
            n = real[x.shape[-1]]
            x, y = x[..., :n], y[..., :n]
            errs[name] = float(np.abs(x - y).max()
                               / max(np.abs(x).max(), 1e-12))
            if not errs[name] <= tol:
                fail(f"phase 28 block placement: {name} ranks vs one device "
                     f"{errs[name]:.3e} > {tol:.0e}")
    bad = dist.check_halo_consistency(
        dict(state=res["state_d"], ice=res["ice_d"]), layout)
    iters = [r["iters"] for r in res["ranks"]]
    if bad or any(it != iters[0] for it in iters):
        fail(f"phase 28 block placement: halo {bad[:4]}, CG iterations "
             f"{iters}")
    say(f"phase 28 block placement (node i on rank i // {b.n_nodes // S}) "
        f"over {S} gloo ranks on the card: 2 CI coupled steps on the level-3 "
        f"globe padded to {b.n_nodes} nodes against one device: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; halo consistent, CG iterations {iters[0]}; forward exchange "
        f"{layout.halo_slots} slots; {wall:.1f} s with the ranks' start "
        f"({card})")
    return dict(errors=errs, halo_slots=layout.halo_slots, wall_s=wall,
                cg_iterations=iters[0])


def phase28(gm, gatm, small: str, card: str, t_start: float) -> dict:
    """The CI coupled step over 2 ranks of a gloo group on the one card
    (``parallel/dist.py``), in float64 and float32, held against the
    one-device step of ``prepare_dist_model`` on the card, the default
    partition's edge cut and halo beside the plain bisection's, and the
    block placement of ``parallel/sharding.py`` (``phase28_block``);
    returns the report (its launches a step per rank among it)."""
    import numpy as np
    import torch
    from fesom2_tpu_torch.model import pi_coupled_step_fn, pi_initial_state
    from fesom2_tpu_torch.parallel import dist, partition
    phase_start(28, t_start)
    S, n_steps = 2, 3
    sync = torch.cuda.synchronize
    ref, inputs = {}, {}
    for dtype, m in gm.items():
        tag = str(dtype).replace("torch.", "")
        dist.prepare_dist_model(m)          # the last phase to use gm
        inputs[tag] = pi_initial_state(m)
        step = pi_coupled_step_fn(m, gatm[dtype])
        s, i = inputs[tag]
        walls, iters = [], []
        for k in range(n_steps):
            sync()
            t0 = time.perf_counter()
            s, i, _ = step(s, i, k)
            sync()
            walls.append(time.perf_counter() - t0)
            iters.append(m.ssh_iters)
        ref[tag] = (s, i, walls, iters)
    t0 = time.perf_counter()
    layout = dist.dist_layout_for_model(gm[torch.float64], S)
    t_layout = time.perf_counter() - t0
    torch.cuda.empty_cache()
    say(f"phase 28 the card before the ranks: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free ({card})")
    say(f"phase 28 layout over {S} ranks in {t_layout:.1f} s (host): owned "
        f"{layout.n_own}, local {layout.n_loc} nodes, {layout.e_loc} "
        f"elements, {layout.ed_loc} edges; a forward exchange sends "
        f"{layout.halo_slots} slots; ice subdomain "
        f"{layout.ice_sub_local['n_nodes']} nodes a rank ({card})")
    report = dict(S=S, layout_s=t_layout, n_own=layout.n_own,
                  n_loc=layout.n_loc, halo_slots=layout.halo_slots)
    # each rank's block-Schwarz tables (build_block_schwarz_local, packed
    # as rank_model packs them) through the kernel against the plain
    # version on the padded tables, here in one process
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import ssh
    rng = np.random.default_rng(28)
    local_pc = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tag = str(dtype).replace("torch.", "")
        for r in range(S):
            pc = dist.rank_block_pc(dist.rank_bundle(layout, r)["block_pc"],
                                    "cuda", dtype)
            x = torch.as_tensor(rng.uniform(-1, 1, pc.node_slots.shape[0]),
                                device="cuda").to(dtype)
            kernels.reset_launches()
            got = ssh.block_schwarz(pc, x)
            want = ssh.block_schwarz_plain(pc, x)
            sync()
            rel = max_abs(got, want) / float(want.abs().max())
            sizes = np.diff(pc.packed.row_off.cpu().numpy())
            local_pc[f"{tag} rank {r}"] = dict(
                rel=rel, blocks=len(sizes), empty=int((sizes == 0).sum()),
                launches=kernels.LAUNCHES["block_schwarz"])
            if not rel <= tol or kernels.LAUNCHES["block_schwarz"] != 1:
                fail(f"phase 28: block_schwarz on rank {r}'s tables {tag}: "
                     f"{local_pc[f'{tag} rank {r}']}")
    say(f"phase 28 block_schwarz on the rank-local tables (packed), kernel "
        f"against plain: " + json.dumps(local_pc))
    report["block_schwarz_rank_local"] = local_pc
    # the default partition (bisection with Kernighan-Lin sweeps) against
    # the plain bisection: edge cut and the halo of layouts of the mesh
    # and tracer statics alone
    mesh7, tst7 = gm[torch.float64].mesh, gm[torch.float64].tracer_statics
    bis = partition._partition_numpy(partition._sphere_xyz(mesh7),
                                     partition.node_weights(mesh7), S)
    # the default partition's node and element slots are the layout's
    # above; the bisection's from a layout of the mesh and tracer statics
    slots = lambda h: {k: h[k] for k in ("node", "elem")}
    report["partitions"] = {
        "default": dict(edge_cut=partition.edge_cut(mesh7, layout.part),
                        halo_slots=slots(layout.halo_slots)),
        "bisection": dict(edge_cut=partition.edge_cut(mesh7, bis),
                          halo_slots=slots(dist.build_layout(
                              mesh7, S, st=tst7, part=bis).halo_slots))}
    say(f"phase 28 partition of the level-7 globe over {S} ranks: edge cut "
        f"and forward-exchange slots " + json.dumps(report["partitions"]))
    report["block_placement"] = phase28_block(small, card)
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= S
                           else [])
    if "nccl" not in backends:
        say(f"phase 28 nccl not run: {torch.cuda.device_count()} card(s), "
            f"nccl takes a card a rank")
    for backend in backends:
        # both dtypes in one start of the ranks, float64 first
        t0 = time.perf_counter()
        results = dist.run_coupled_steps(
            [dict(model=m, atm=gatm[dtype], state=inputs[tag][0],
                  ice=inputs[tag][1], n_steps=n_steps, profile=True)
             for dtype, m in gm.items()
             for tag in [str(dtype).replace("torch.", "")]],
            layout, backend=backend, device="cuda")
        wall = time.perf_counter() - t0
        for (dtype, m), res in zip(gm.items(), results):
            tag = str(dtype).replace("torch.", "")
            label = f"phase 28 {backend} {tag}"
            s_ref, i_ref, ref_walls, ref_iters = ref[tag]
            errs = dist.relative_errors(s_ref, i_ref, res["state"],
                                        res["ice"])
            for name, tol in dist.OCEAN_TOL + dist.ICE_TOL:
                # float32: CG to 2e-5 under two preconditioners (the
                # port's f32 CG is held to JAX's within 2e-3 on eta,
                # tests/test_torch_ssh_cg_f32.py)
                lim = tol if dtype == torch.float64 else 1e-2
                if not errs[name] <= lim:
                    fail(f"{label}: {name} ranks vs one device "
                         f"{errs[name]:.3e} > {lim:.0e}")
            bad = dist.check_halo_consistency(
                dict(state=res["state_d"], ice=res["ice_d"]), layout)
            if bad:
                fail(f"{label}: halo slots differ from their owners: "
                     f"{bad[:6]}")
            ranks = res["ranks"]
            iters = [r["iters"] for r in ranks]
            if any(it != iters[0] for it in iters):
                fail(f"{label}: the ranks took different CG iterations "
                     f"{iters}")
            if any(f != [0] * n_steps for f in (r["flags"] for r in ranks)):
                fail(f"{label}: the blowup scan flagged a step")
            for r, rk in enumerate(ranks):
                for k, launches in enumerate(rk["launches"]):
                    missing = [n for n in DIST_PATH_KERNELS
                               if launches.get(n, 0) <= 0]
                    if missing or launches.get("mevp_subcycles") != 120 \
                            or launches.get("ring_spmv", 0) != 0:
                        fail(f"{label}: rank {r} step {k} launches "
                             f"{launches} (missing {missing})")
            steady = lambda xs: sum(xs[1:]) / max(len(xs) - 1, 1)
            step_s = max(steady(r["step_seconds"]) for r in ranks)
            exch = []
            for rk in ranks:
                last = rk["exchanges"][-1]
                exch.append(dict(
                    host_ms=1e3 * sum(last["seconds"].values()),
                    bytes=sum(last["bytes"].values()),
                    calls=sum(last["calls"].values()),
                    by_kind={k: dict(calls=last["calls"][k],
                                     bytes=last["bytes"][k],
                                     host_ms=1e3 * last["seconds"][k])
                             for k in last["calls"]}))
            prof = [rk["profile"] for rk in ranks]
            entry = dict(
                errors=errs, cg_iterations=iters[0],
                one_device_cg_iterations=ref_iters,
                steps_per_s=1.0 / step_s,
                one_device_steps_per_s=1.0 / steady(ref_walls),
                launches_a_step=[rk["launches"][-1] for rk in ranks],
                exchange=exch, profile=prof, staged=ranks[0]["stage"],
                wall_s=wall, payload_s=res["payload_seconds"],
                ranks_s=res["ranks_seconds"],
                rank_setup_s=[rk["setup_seconds"] for rk in ranks],
                rank_peak_gib=[rk["peak_gib"] for rk in ranks],
                rank_clock_s=[{k: v - rk["clock"]["start"]
                               for k, v in rk["clock"].items()}
                              for rk in ranks])
            report[f"{backend}_{tag}"] = entry
            say(f"{label}: {n_steps} coupled steps over {S} ranks "
                f"(backend {ranks[0]['backend']}, buffers through pinned "
                f"host memory: {ranks[0]['stage']}) against one device: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f"; halo consistent; CG iterations {iters[0]} (one "
                f"device, Jacobi: {ref_iters}); both dtypes {wall:.1f} s: "
                f"payloads {res['payload_seconds']:.1f} s, ranks "
                f"{res['ranks_seconds']:.1f} s (their model "
                f"{max(rk['setup_seconds'] for rk in ranks):.1f} s, peak "
                f"memory {[rk['peak_gib'] for rk in ranks]} GiB; seconds "
                f"from the start to rank 0's entry, joining the group, end "
                f"and receipt: " + ", ".join(
                    f"{rk['clock'][k] - rk['clock']['start']:.1f}"
                    for rk in ranks[:1]
                    for k in ("entry", "joined", "done", "received"))
                + f") ({card})")
            for r, (ex, pr) in enumerate(zip(exch, prof)):
                say(f"{label} rank {r} a step: {1.0 / step_s:.3f} steps/s "
                    f"(one device {1.0 / steady(ref_walls):.3f}); exchange "
                    f"{ex['calls']} calls, {ex['bytes']} bytes, host "
                    f"{ex['host_ms']:.1f} ms; profiled step wall "
                    f"{pr['wall_ms']:.1f} ms, device {pr['device_ms']:.1f} "
                    f"ms of which under the exchange spans "
                    f"{pr['exchange_device_ms']:.1f} ms ({card})")
                say(f"{label} rank {r} exchange by kind ({card}): "
                    + json.dumps(ex["by_kind"]))
                say(f"{label} rank {r} launches a step: "
                    + json.dumps({k: v for k, v in
                                  ranks[r]["launches"][-1].items() if v}))
    return report


MKRUN_NAMELISTS = {
    "namelist.config": "&modelname\nrunid='fesom'\n/\n&timestep\n"
    "step_per_day=96\nrun_length=1\nrun_length_unit='d'\n/\n&clockinit\n"
    "timenew=0.0\ndaynew=1\nyearnew=1948\n/\n&ale_def\nwhich_ALE='zstar'\n"
    "use_partial_cell=.true.\n/\n&geometry\ncartesian=.false.\n"
    "cyclic_length=360.\nforce_rotation=.true.\n/\n&run_config\n"
    "use_ice=.true.\nuse_sw_pene=.true.\ntoy_ocean=.false.\n/\n",
    "namelist.oce": "&oce_dyn\nstate_equation=1\nvisc_option=5\n"
    "gamma0=0.003, gamma1=0.1, gamma2=0.285\neasy_bs_return=1.5\n"
    "w_split=.true.\nw_max_cfl=1.0\nmix_scheme='KPP'\nFer_GM=.true.\n"
    "Redi=.true.\nK_GM_max=2000.0\nK_GM_min=2.0\nK_GM_bvref=2\n"
    "K_GM_rampmax=-1.0\nK_GM_rampmin=-1.0\nscaling_Ferreira=.false.\n"
    "scaling_Rossby=.false.\nscaling_resolution=.true.\n/\n&oce_tra\n"
    "K_ver=1.0e-5\nK_hor=3000.\nsurf_relax_T=0.0\nsurf_relax_S=1.929e-06\n"
    "clim_relax=0.0\nref_sss_local=.true.\nref_sss=34.\n"
    "tra_adv_hor='MFCT'\ntra_adv_ver='QR4C'\ntra_adv_lim='FCT'\n/\n",
    "namelist.ice": "&ice_dyn\nwhichEVP=1\nevp_rheol_steps=120\n"
    "evp_subdomain_lat=40.0\n/\n",
    "namelist.forcing": "&nam_sbc\n/\n",
}
MKRUN_SETUP = """mesh: test_global
forcing: built_in_code
namelist.oce:
  oce_dyn:
    Div_c: 0.5
    Leith_c: 0.05
namelist.io:
  nml_list:
    io_list:
      "sst       ":
        freq: 1
        unit: s
        prec: 8
      "ssh       ":
        freq: 1
        unit: s
        prec: 8
      "temp      ":
        freq: 1
        unit: s
        prec: 8
      "salt      ":
        freq: 2
        unit: s
        prec: 8
      "a_ice     ":
        freq: 1
        unit: s
        prec: 8
      "m_ice     ":
        freq: 1
        unit: s
        prec: 8
fcheck:
  temp: 1.701768707848739
  a_ice: 0.2
"""


def phase29(globe_path: str, card: str, t_start: float) -> dict:
    """``mkrun`` on the card: a setup.yml and the base namelists of the CI
    configuration on the level-7 globe, 2 steps by ``run_setup``, held
    against a ``run_pi`` of the same configuration; returns the report."""
    import shutil
    import numpy as np
    import torch
    from fesom2_tpu_torch import kernels, mkrun
    from fesom2_tpu_torch.io.streams import streams_from_io_list
    from fesom2_tpu_torch.model import pi_initial_state, setup_pi_model
    from fesom2_tpu_torch.post.fcheck import field_means
    from fesom2_tpu_torch.run import run_pi
    phase_start(29, t_start)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "mkrun"
    shutil.rmtree(root, ignore_errors=True)
    (root / "ref" / "config").mkdir(parents=True)
    for name, text in MKRUN_NAMELISTS.items():
        (root / "ref" / "config" / name).write_text(text)
    (root / "paths.yml").write_text(f"mesh:\n  test_global: '{globe_path}'\n")
    (root / "setup.yml").write_text(MKRUN_SETUP)
    os.environ["FESOM2_REF_ROOT"] = str(root / "ref")
    os.environ["FESOM2_TPU_PATHS"] = str(root / "paths.yml")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok, means, goldens = mkrun.run_setup(str(root / "setup.yml"),
                                         str(root / "mkrun"), steps=2,
                                         device="cuda", verbose=False)
    torch.cuda.synchronize()
    t_mkrun = time.perf_counter() - t0
    n_launch = sum(kernels.LAUNCHES.values())
    if n_launch <= 0 or kernels.LAUNCHES["mevp_subcycles"] != 2:
        fail(f"phase 29: mkrun's run launched {dict(kernels.LAUNCHES)}")
    cfg, mesh_path, forcing_path, _, _, io_list = mkrun.load_setup(
        str(root / "setup.yml"))
    if forcing_path is not None or mesh_path != globe_path:
        fail(f"phase 29: load_setup gave {mesh_path}, {forcing_path}")
    m, atm = setup_pi_model(mesh_path, device="cuda", cfg=cfg)
    run_pi(m, atm, *pi_initial_state(m), 2, result_path=str(root / "run_pi"),
           stream_defs=streams_from_io_list(io_list, m.mesh, m.cfg, atm=atm))
    direct = field_means(str(root / "run_pi"))
    if set(direct) != set(means) or len(means) < 6:
        fail(f"phase 29: fields {sorted(means)} against {sorted(direct)}")
    worst = max(abs(means[k] - direct[k]) / max(abs(direct[k]), 1e-300)
                for k in direct)
    if not worst <= 1e-12:
        fail(f"phase 29: mkrun's means against run_pi's: {worst:.3e}")
    if any(not np.isfinite(v) for v in means.values()):
        fail(f"phase 29: a mean is not finite: {means}")
    inside, _ = mkrun.check_goldens(means, {k: v * 1.01 for k, v in
                                            means.items()}, rtol=0.05)
    outside, report = mkrun.check_goldens(
        means, dict(means, temp=means["temp"] * 1.2), rtol=0.05)
    if not inside or outside or ok != all(
            abs(means.get(k, np.inf) - g) / max(abs(g), 1e-3) <= 0.05
            for k, g in goldens.items()):
        fail(f"phase 29: golden verdicts {inside}, {outside}, {ok}")
    say(f"phase 29 mkrun: 2 CI coupled steps on the level-7 globe from "
        f"setup.yml in {t_mkrun:.1f} s (setup included; {n_launch} kernel "
        f"launches), {len(means)} field means, worst against run_pi's "
        f"{worst:.3e}; verdicts: within 5% passes, 20% off fails, the "
        f"yaml's own goldens {'pass' if ok else 'fail'} ({card})")
    say(f"phase 29 means ({card}): " + json.dumps(means))
    shutil.rmtree(root, ignore_errors=True)
    return dict(seconds=t_mkrun, means=means, worst_vs_run_pi=worst,
                yaml_goldens_pass=ok, launches=n_launch)


# the keys of the JAX package's profile_pi_phases table
# (fesom2_tpu/utils/profiling.py:87-194), which the port's must return
PROFILE_KEYS = ("coupled_total", "ocean_total", "ice_plus_forcing",
                "eos_pressure", "mixing", "momentum", "ssh_solve",
                "vert_vel", "tracers", "ice_total", "ice_evp",
                "sum_of_phases")


def phase30(post_dir: str, mesh, card: str, t_start: float) -> dict:
    """Post-processing on phase 26's level-7 output directory: the mesh
    loader against the model's tables, the FPost products on a 2-degree
    grid, the density-space MOC, the golden means; then the smoothing and
    integrals of ``utils/support.py`` on the card against their plain
    versions.  Returns the report (host seconds of each product)."""
    import numpy as np
    import torch
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.core import ops
    from fesom2_tpu_torch.core.diagnostics import STD_DENS
    from fesom2_tpu_torch.io.netcdf import read_vars
    from fesom2_tpu_torch.post import fcheck, fpost, mesh_loader, moc
    from fesom2_tpu_torch.utils import support
    phase_start(30, t_start)
    h = lambda x: x.detach().cpu().numpy()
    t0 = time.perf_counter()
    pm = mesh_loader.load_mesh(post_dir)
    seconds = {"load_mesh": time.perf_counter() - t0}
    geo = np.degrees(h(mesh.geo_coords))
    for name, got, want in (
            ("x2", pm.x2, geo[:, 0]), ("y2", pm.y2, geo[:, 1]),
            ("elem", pm.elem, h(mesh.elem_nodes)),
            ("zlev", pm.zlev, h(mesh.zbar)), ("zmid", pm.zmid, h(mesh.Z)),
            ("nlevels_nod2D", pm.nlevels_nod2D, h(mesh.nlevels_node)),
            ("nlevels_elem", pm.nlevels_elem, h(mesh.nlevels_elem)),
            ("area", pm.area, h(mesh.area)),
            ("elem_area", pm.elem_area, h(mesh.elem_area))):
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"phase 30: load_mesh's {name} is not the model's")
    out = os.path.join(post_dir, "fpost")
    written = []
    for flag in ("do_grid_info", "do_TS3", "do_UVnorm", "do_MOC"):
        cfg = fpost.FpostConfig(datapath=post_dir, outpath=out, RegDx=2.0,
                                RegDy=2.0, **{flag: True})
        t0 = time.perf_counter()
        written += fpost.run_fpost(cfg, mesh=pm)
        seconds[flag[3:]] = time.perf_counter() - t0
    if written != ["grid_info.nc", "TS3.nc", "uv_norm.nc", "moc.nc"]:
        fail(f"phase 30: run_fpost wrote {written}")
    rd = lambda f, names: read_vars(os.path.join(out, f), names)
    gi = rd("grid_info.nc", ["mask2", "mask3"])
    wet = gi["mask3"].astype(bool)                       # [47, ny, nx]
    ts3 = rd("TS3.nc", ["temp", "salt", "time"])
    uvn = rd("uv_norm.nc", ["uv_norm"])["uv_norm"]
    mocf = rd("moc.nc", ["moc", "lat_moc"])
    n_rec = ts3["time"].shape[0]
    for name, arr in (("temp", ts3["temp"]), ("salt", ts3["salt"]),
                      ("uv_norm", uvn)):
        if arr.shape != (n_rec,) + wet.shape \
                or not np.isfinite(arr[:, wet]).all():
            fail(f"phase 30: {name} {arr.shape} not finite where the grid "
                 f"mask is wet")
    psi = mocf["moc"]
    t0 = time.perf_counter()
    vdz = mesh_loader.read_stream(post_dir, "std_dens_VDZ", 1948)
    lat_b, _, psi_d = moc.moc_dens(vdz, pm.elem_area,
                                   pm.y2[pm.elem].mean(-1), STD_DENS)
    seconds["moc_dens"] = time.perf_counter() - t0
    # both streamfunctions against the same sums taken on the card by
    # index_add_ over the latitude bins (the post tools bin with np.add.at)
    dev = mesh.zbar.device

    def binned(vals, lat, bins):
        edges = np.concatenate([[-90.0], 0.5 * (bins[1:] + bins[:-1]),
                                [90.0]])
        ib = np.clip(np.digitize(lat, edges) - 1, 0, bins.size - 1)
        out = torch.zeros(bins.size, vals.shape[0], dtype=torch.float64,
                          device=dev)
        return out.index_add_(0, torch.as_tensor(ib, device=dev),
                              torch.as_tensor(np.asarray(vals, np.float64),
                                              device=dev).T)

    w_mean = fpost.read_records(post_dir, "w", 1948)[0].mean(0)
    bins_w = np.arange(-81.0, 90.0 + 1e-9, 2.0)        # do_moc's, 2 deg
    ref_w = torch.cumsum(binned(w_mean * pm.area[0], pm.y2, bins_w), 0) \
        / 1e6
    edges_d = np.concatenate([[-90.0], 0.5 * (lat_b[1:] + lat_b[:-1]),
                              [90.0]])
    vint = binned(vdz * pm.elem_area[None], pm.y2[pm.elem].mean(-1), lat_b) \
        / torch.as_tensor(np.diff(edges_d) * 111194.93, device=dev)[:, None]
    ref_d = -torch.flip(torch.cumsum(torch.flip(vint, [1]), 1), [1]) / 1e6
    moc_err = [max_abs(torch.as_tensor(np.asarray(p_, np.float64)),
                       r.cpu()) / max(float(r.abs().max()), 1e-300)
               for p_, r in ((psi, ref_w), (psi_d, ref_d))]
    if not np.isfinite(psi).all() or not np.isfinite(psi_d).all() \
            or psi.shape != tuple(ref_w.shape) or not max(moc_err) <= 1e-10:
        fail(f"phase 30: the MOC from w {psi.shape} or in density classes "
             f"not finite, or off the card's sums: {moc_err}")
    gold = os.path.join(post_dir, "goldens.yml")
    t0 = time.perf_counter()
    fcheck.write_goldens(post_dir, gold)
    passes = fcheck.fcheck(post_dir, gold, verbose=False)
    seconds["goldens"] = time.perf_counter() - t0
    means = fcheck.load_goldens(gold)
    off = os.path.join(post_dir, "goldens_off.yml")
    with open(off, "w") as f:
        f.write("fcheck:\n" + "".join(f"  {k}: {v * 1.01!r}\n"
                                      for k, v in means.items()))
    if not passes or fcheck.fcheck(post_dir, off, verbose=False) \
            or len(means) < 10:
        fail(f"phase 30: the golden check on the run's own means "
             f"{passes}, on the same 1 % off not failing, or {len(means)} "
             f"means")
    say(f"phase 30 post on phase 26's run ({n_rec} records of "
        f"{pm.n2d} nodes, {len(pm.zmid)} layers): load_mesh equal to the "
        f"model's tables; fpost on the 2-degree grid "
        f"{list(wet.shape[1:])} ({int(gi['mask2'].sum())} wet columns): "
        f"every product finite where the mask is wet, max|psi| "
        f"{np.abs(psi).max():.3f} Sv from w, {np.abs(psi_d).max():.3f} Sv "
        f"in density classes (both {max(moc_err):.1e} from the card's "
        f"sums); {len(means)} golden means pass, 1 % off "
        f"fails; host s " + json.dumps(
            {k: round(v, 3) for k, v in seconds.items()}) + f" ({card})")
    # the smoothing and the integrals on the card: smooth_nod and
    # smooth_elem launch elem_to_node_mean's one-thread-per-output form;
    # against the same passes with its plain version on the card
    sst = torch.as_tensor(mesh_loader.read_stream(post_dir, "sst", 1948),
                          device=mesh.zbar.device)
    u = torch.as_tensor(mesh_loader.read_stream(post_dir, "u", 1948),
                        device=mesh.zbar.device)
    em = lambda x: ops.elem_mean_node(x, mesh)
    plain = lambda x: ops.elem_to_node_mean_flat_plain(x, mesh)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sn = support.smooth_nod(sst, 3, mesh)
    se = support.smooth_elem(u, 2, mesh)
    torch.cuda.synchronize()
    t_smooth = time.perf_counter() - t0
    n_launch = kernels.LAUNCHES["elem_to_node_mean"]
    want_n, want_e = sst, u
    for _ in range(3):
        want_n = plain(em(want_n))
    for _ in range(2):
        want_e = em(plain(want_e))
    err = max(max_abs(sn, want_n) / float(want_n.abs().max()),
              max_abs(se, want_e) / float(want_e.abs().max()))
    area_int = float(support.integrate_nod_2d(torch.ones_like(sst), mesh))
    if n_launch != 5 or not err <= 1e-12 \
            or not abs(area_int - float(mesh.area[0].sum())) <= 1e-12 \
            * area_int:
        fail(f"phase 30: smoothing on the card: {n_launch} launches of "
             f"elem_to_node_mean (5 expected), {err:.3e} from the plain "
             f"passes")
    say(f"phase 30 smooth_nod (3 passes of sst) and smooth_elem (2 passes "
        f"of u {list(u.shape)}) on the card: {n_launch} "
        f"launches of elem_to_node_mean, {err:.3e} of max from the plain "
        f"passes, {t_smooth * 1e3:.2f} ms ({card})")
    return dict(host_seconds=seconds, max_psi_w_sv=float(np.abs(psi).max()),
                max_psi_dens_sv=float(np.abs(psi_d).max()), moc_err=moc_err,
                golden_means=len(means), smoothing_err=err,
                smoothing_ms=t_smooth * 1e3, smoothing_launches=n_launch)


def _atmosphere(address, n_events: int, errors: list):
    """The atmosphere of phase 31: for each coupling event, wait for the
    ocean's send fields, then post seeded ECHAM fields and the net heat
    flux the correction conserves."""
    import numpy as np
    from fesom2_tpu_torch.coupler import RECV_FIELDS_ECHAM, SocketTransport
    try:
        cl = SocketTransport(address)
        for e in range(n_events):
            if cl.get(f"o2a_event_{e}", timeout=60.0) is None:
                raise TimeoutError(f"no send for event {e}")
            sst = cl.get("sst_feom", timeout=60.0)
            n = sst.shape[0]
            rng = np.random.default_rng(100 + e)
            u = lambda lo, hi: rng.uniform(lo, hi, n)
            ranges = dict(heat_oce=(-300.0, 100.0), heat_ico=(-150.0, 80.0),
                          heat_swo=(0.0, 250.0), evap_oce=(-5e-8, 0.0),
                          subl_oce=(-1e-8, 0.0), prec_oce=(0.0, 3e-8),
                          snow_oce=(0.0, 2e-8), hydr_oce=(0.0, 1e-9),
                          taux_oce=(-0.2, 0.2), tauy_oce=(-0.2, 0.2),
                          taux_ico=(-0.2, 0.2), tauy_ico=(-0.2, 0.2))
            for name in RECV_FIELDS_ECHAM:
                cl.put(name, u(*ranges[name]))
            cl.put("heat_net", np.array([-2.0e14 - 1.0e13 * e]))
            cl.put(f"a2o_event_{e}", np.ones(1))
        cl.close()
    except Exception as err:                     # reported by the ocean
        errors.append(repr(err))


def coupler_run(m, atm, n_steps: int, every: int) -> dict:
    """``n_steps`` coupled-mode ice steps of model ``m`` (the ocean held at
    its initial state) against the seeded atmosphere thread over a local
    socket: ``collect`` every step, ``send``/``recv`` every ``every``
    steps (and once before the first), ``force_flux_consv`` on heat_oce.
    Returns the final ice, the corrected fields' integrals against the
    atmosphere's, the kernel launches per step and the host ms a coupling
    event."""
    import threading
    import numpy as np
    import torch
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.coupler import (CplDriver, OasisEndpoint,
                                          force_flux_consv)
    from fesom2_tpu_torch.forcing.atmos import update_atm_forcing
    from fesom2_tpu_torch.ice.coupling import ocean2ice
    from fesom2_tpu_torch.ice.state import zero_ice_forcing
    from fesom2_tpu_torch.ice.step import ice_timestep_cpl
    from fesom2_tpu_torch.model import pi_initial_state
    mesh, dev = m.mesh, m.mesh.zbar.device
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    cfg = m.cfg
    state, ice = pi_initial_state(m)
    surf = ocean2ice(state, mesh)
    n_events = 1 + n_steps // every
    ep = OasisEndpoint(("127.0.0.1", 0))
    errors = []
    th = threading.Thread(target=_atmosphere, args=(ep.address, n_events,
                                                    errors), daemon=True)
    th.start()
    drv = CplDriver(mesh, ep)
    ones = torch.ones_like(mesh.area[0])
    integrals, event_ms, launches = [], [], []

    def exchange(e):
        sync()
        t0 = time.perf_counter()
        drv.send()
        ep.put(f"o2a_event_{e}", np.ones(1))
        if ep.get(f"a2o_event_{e}", timeout=60.0) is None:
            fail(f"coupler: no answer to event {e}: {errors}")
        fluxes, stresses = drv.recv()
        net = float(ep.get("heat_net").reshape(-1)[0])
        heat = force_flux_consv(fluxes.oce_heat_flux, ones, net, mesh)
        fluxes = dataclasses.replace(fluxes, oce_heat_flux=heat)
        sync()
        event_ms.append((time.perf_counter() - t0) * 1e3)
        got = float((heat * mesh.area[0]).sum())
        integrals.append(abs(got - net) / abs(net))
        return fluxes, stresses

    try:
        drv.collect(state, ice)
        fluxes, stresses = exchange(0)
        for k in range(n_steps):
            kernels.reset_launches()
            ifc = update_atm_forcing(atm, k * cfg.dt, ice.u_ice, ice.v_ice,
                                     surf.u_w, surf.v_w, surf.T_oc,
                                     zero_ice_forcing(mesh))
            ifc = dataclasses.replace(ifc, **stresses)
            ice = ice_timestep_cpl(ice, mesh, ifc, fluxes, surf, cfg, False,
                                   ref_sss=cfg.tra.ref_sss,
                                   ref_sss_local=cfg.tra.ref_sss_local)
            sync()
            launches.append(dict(kernels.LAUNCHES))
            drv.collect(state, ice)
            if (k + 1) % every == 0:
                fluxes, stresses = exchange((k + 1) // every)
    finally:
        th.join(timeout=60.0)
        ep.close()
    if errors:
        fail(f"coupler: the atmosphere thread failed: {errors}")
    return dict(ice=ice, integrals=integrals, event_ms=event_ms,
                launches=launches, events=len(event_ms))


def phase31(gm, gatm, small: str, card: str, t_start: float) -> dict:
    """The coupler at full width: 4 coupled-mode ice steps on the level-7
    globe over a local socket to an atmosphere thread, and the same on the
    level-3 globe card against CPU."""
    import torch
    from fesom2_tpu_torch.model import setup_pi_model
    phase_start(31, t_start)
    m = gm[torch.float64]
    t0 = time.perf_counter()
    r = coupler_run(m, gatm[torch.float64], 4, 2)
    wall = time.perf_counter() - t0
    ice = r["ice"]
    bad = [f.name for f in dataclasses.fields(ice)
           if not bool(torch.isfinite(getattr(ice, f.name)).all())]
    per_step = [(ln["mevp_subcycles"], ln["elem_contrib_to_nodes"])
                for ln in r["launches"]]
    if bad or r["events"] != 3 or max(r["integrals"]) > 1e-12 \
            or any(mv != 1 or ecn <= 0 for mv, ecn in per_step):
        fail(f"phase 31: fields not finite {bad}, {r['events']} events, "
             f"integrals {r['integrals']}, launches (mevp_subcycles, "
             f"elem_contrib_to_nodes) a step {per_step}")
    say(f"phase 31 coupler on the level-7 globe: 4 coupled-mode ice steps "
        f"in {wall:.2f} s, {r['events']} coupling events over a local "
        f"socket (host ms an event, send + atmosphere + recv + correction: "
        f"{[round(v, 2) for v in r['event_ms']]}), heat_oce's integral "
        f"against the atmosphere's net {max(r['integrals']):.2e}, "
        f"mevp_subcycles once a step, elem_contrib_to_nodes "
        f"{per_step[0][1]} a step; a_ice max {float(ice.a_ice.max()):.3f}, "
        f"max|u_ice| {float(ice.u_ice.abs().max()):.3f} m/s ({card})")
    sides = []
    for d in ("cuda", "cpu"):
        ms, atm_s = setup_pi_model(small, device=d)
        sides.append(coupler_run(ms, atm_s, 4, 2)["ice"])
    worst = 0.0
    for f in dataclasses.fields(sides[1]):
        g, c = getattr(sides[0], f.name), getattr(sides[1], f.name)
        rel = max_abs(g.cpu(), c) / max(float(c.abs().max()), 1e-300)
        worst = max(worst, rel)
        if not rel <= 1e-8:
            fail(f"phase 31: level-3 coupler run card vs CPU {f.name} "
                 f"{rel:.3e} > 1e-8")
    say(f"phase 31 level-3 coupler run card vs CPU: worst ice field "
        f"{worst:.3e} of max|cpu|")
    return dict(wall_s=wall, event_ms=r["event_ms"],
                integral_err=max(r["integrals"]),
                launches_a_step=r["launches"][-1], card_vs_cpu=worst)


def phase32(globe_path: str, span_ms: dict, coupled_kernels, card: str,
            t_start: float) -> dict:
    """``profile_pi_phases`` on the level-7 CI step in float64 and
    float32, n=5, beside phase 12's device ms a step per span."""
    import math
    import torch
    from fesom2_tpu_torch import kernels
    from fesom2_tpu_torch.utils.profiling import profile_pi_phases
    phase_start(32, t_start)
    report = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        kernels.reset_launches()
        t0 = time.perf_counter()
        table = profile_pi_phases(globe_path, device="cuda", dtype=dtype,
                                  n=5, verbose=False)
        wall = time.perf_counter() - t0
        missing = [k for k in coupled_kernels if kernels.LAUNCHES[k] <= 0]
        if set(table) != set(PROFILE_KEYS) or missing or not all(
                math.isfinite(v) and v >= 0.0 for v in table.values()):
            fail(f"phase 32 {tag}: keys {sorted(table)}, kernels not "
                 f"launched {missing}, values {table}")
        ms = {k: table[k] * 1e3 for k in PROFILE_KEYS}
        report[tag] = dict(ms=ms, wall_s=wall)
        say(f"phase 32 {tag} profile_pi_phases (ms a call, n=5; "
            f"{wall:.1f} s with the setup): " + json.dumps(
                {k: round(v, 3) for k, v in ms.items()}) + f" ({card})")
        say(f"phase 32 {tag} beside phase 12's device ms a step per span: "
            + json.dumps({k: round(v, 3) for k, v in
                          span_ms.get("ci", {}).get(tag, {}).items()}))
    return report


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
    import dataclasses
    from fesom2_tpu_torch.core import eos, ops, ssh, tracers
    from fesom2_tpu_torch.forcing.atmos import update_atm_forcing
    from fesom2_tpu_torch.ice import evp
    from fesom2_tpu_torch.ice.coupling import ocean2ice
    from fesom2_tpu_torch.ice.state import allocate_ice, zero_ice_forcing
    from fesom2_tpu_torch.core.state import zero_forcing
    from fesom2_tpu_torch.core.mixing import kpp
    from fesom2_tpu_torch.mesh import build_mesh, cluster, globe, read_raw_mesh
    from fesom2_tpu_torch.mesh.channel import channel_raw_mesh, write_mesh
    from fesom2_tpu_torch.model import (coupled_step_fn, pi_coupled_step_fn,
                                        pi_initial_state, setup_pi_model,
                                        setup_soufflet_model)
    from fesom2_tpu_torch.run import (globe_ocean_inputs, run_pi,
                                      run_pi_ocean, run_soufflet)
    from fesom2_tpu_torch.scripts import gather_cost_model as probe
    from fesom2_tpu_torch.model import Model
    from fesom2_tpu_torch.ice.icepack import (IcepackConfig,
                                              init_icepack_state)
    from fesom2_tpu_torch.ice.icepack import driver as icepack_driver
    from fesom2_tpu_torch.ice.icepack import itd as icepack_itd
    from fesom2_tpu_torch.ice.icepack import thermo_vertical as tvert
    icepack_models, bl99_report, icepack_cpu = {}, {}, {}
    dmoc_counts = {}
    from fesom2_tpu_torch.core import diagnostics

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

    PHASES.append((1, 0.0))

    # phase 2 ------------------------------------------------------------
    phase_start(2, t_start)
    t0 = time.perf_counter()
    path = build.build()
    kernels.library()
    say(f"phase 2 build: {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in build.ptxas_report().splitlines():
        say(f"  {line.strip()}")

    # phase 3 ------------------------------------------------------------
    phase_start(3, t_start)
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
    # the fast configuration (bench.py's BENCH_PARITY=fast: linfs + PP,
    # full cells, no GM/Redi) on the same globe: its static linfs ring
    # feeds phase 3, its models phase 14
    gf, gfatm, gf_setup = {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gf[dtype], gfatm[dtype] = setup_pi_model(globe_path, device=dev,
                                                 dtype=dtype, parity="fast")
        torch.cuda.synchronize()
        gf_setup[dtype] = time.perf_counter() - t0
    gmesh = gm[torch.float64].mesh
    say(f"phase 3 globe: N={gmesh.n_nodes} E={gmesh.n_elems} "
        f"Ed={gmesh.n_edges} layers={gmesh.nl - 1} levels per column "
        f"{int(gmesh.nlevels_node.min())}-{int(gmesh.nlevels_node.max())}")
    # the CI configuration under the ice shelf of globe.shelf_draft on the
    # same globe: its tables and its state after one coupled step feed
    # phase 3, its models phase 16
    draft7 = globe.shelf_draft(read_raw_mesh(globe_path))
    sm, satm, sm_setup, s1 = {}, {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm[dtype], satm[dtype] = setup_pi_model(globe_path, device=dev,
                                                dtype=dtype,
                                                cavity_depth=draft7)
        torch.cuda.synchronize()
        sm_setup[dtype] = time.perf_counter() - t0
        s1[dtype] = pi_coupled_step_fn(sm[dtype], satm[dtype])(
            *pi_initial_state(sm[dtype]), 0)
    smesh = sm[torch.float64].mesh
    say(f"phase 3 shelf globe: {int((draft7 < 0).sum())} of "
        f"{smesh.n_nodes} nodes under the shelf (250 m draft south of 62S); "
        f"columns with their top below the surface: "
        f"{int((smesh.ulevels_node > 1).sum())} nodes, "
        f"{int((smesh.ulevels_elem > 1).sum())} elements, top row up to "
        f"{int(smesh.ulevels_node.max()) - 1}; fct_bounds neighbour table "
        f"M={smesh.cluster.fct_slot.shape[0]} (shelf-free "
        f"{gmesh.cluster.fct_slot.shape[0]}), {split_entries(smesh.cluster)} "
        f"entries more than (node, neighbour) pairs: pairs whose shared "
        f"wet levels are two runs")

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

    schwarz_padded = {}     # block_schwarz: the padded tables' bound

    def bs_case(label, m, dtype):
        """block_schwarz with model m's preconditioner (the kernel on its
        packed layout) on a random residual, held against the plain version
        on the padded tables; bound: the packed layout's bytes (the padded
        tables' kept beside it); library call: one bmm over the padded
        inverses, the blocks' local solves only."""
        pc, N = m.ssh_block_pc, m.mesh.n_nodes
        size = torch.empty((), dtype=dtype).element_size()
        x = rand(N, dtype=dtype)
        nb, K = pc.block_ids.shape
        sizes = np.diff(pc.packed.row_off.cpu().numpy())
        rb = x[pc.block_ids.long().clamp_min(0)][..., None].contiguous()
        case = f"{label} blocks [{nb}, {K}, {K}] (library: local solves only)"
        schwarz_padded[(dtype, case)] = dict(
            padded_bound_ms=kernels.bound_ms(ssh.block_schwarz_work(
                N, nb, K, pc.node_slots.shape[1], pc.coarse_ids.shape[1],
                size), dtype)[0],
            block_nodes=[int(sizes.min()), float(np.median(sizes)),
                         int(sizes.max())],
            packed_entries=int(pc.packed.inv.numel()),
            padded_entries=int(pc.inv_blocks.numel()),
            tiles=int(pc.packed.tiles.shape[0]))
        return ("block_schwarz", case,
                lambda: pc(x),
                lambda: ssh.block_schwarz_plain(pc, x), False,
                ssh.block_schwarz_packed_work(
                    N, sizes, pc.packed.node_slots.shape[1],
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
                    lambda f=f: ops.edge_signed_reduce2_plain(f, mesh), True,
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
                        lambda f=f: ops.edge_divergence_plain(f, mesh), True,
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
        """ring_spmv with model m's ring: an ALE ring's values rebuilt from
        a 0.5 m hbar perturbation as a step does, a linfs ring as it is;
        library call: a CSR product."""
        size = torch.empty((), dtype=dtype).element_size()
        hbar_e = rand(m.mesh.n_elems, lo=-0.5, hi=0.5, dtype=dtype)
        op = m.ssh_ring.materialize(hbar_e) \
            if isinstance(m.ssh_ring, ssh.RingALE) else m.ssh_ring
        N = m.mesh.n_nodes
        x = rand(N, dtype=dtype)
        Kr = op.cols.shape[0]
        ring = csr(torch.arange(N, device=dev).repeat(Kr),
                   op.cols.long().reshape(-1), op.vals.reshape(-1), (N, N))
        xcol = x[:, None].contiguous()
        return ("ring_spmv", f"{label} ring {list(op.cols.shape)}",
                lambda: op(x),
                lambda: ssh.ring_spmv_plain(op.cols, op.vals, x), True,
                ssh.ring_spmv_work(Kr, N, size), lambda: ring @ xcol)

    def shelf_cases(dtype):
        """The kernels whose columns or tables the ice-shelf cavities
        change, on the shelf globe: fct_bounds and elem_to_node_mean (with
        the level mask and without; library call for the latter: a CSR
        product with the area weights) on its tables, bitwise, kpp_column
        (bitwise in float64) and pressure_bv on its state after one
        coupled step."""
        m, (st, _, forcing) = sm[dtype], s1[dtype]
        mesh = m.mesh
        L, N, E = mesh.nl - 1, mesh.n_nodes, mesh.n_elems
        K = mesh.nod_in_elem.shape[1]
        size = torch.empty((), dtype=dtype).element_size()
        ct = mesh.cluster
        wet = int(mesh.node_layer_mask.sum())
        ttf = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        lo_ = rand(2, L, N, lo=0.0, hi=30.0, dtype=dtype)
        out = [("fct_bounds", f"shelf ttf,lo {[2, L, N]}",
                lambda: tracers.fct_bounds(ttf, lo_, mesh),
                lambda: tracers.fct_bounds_plain(ttf, lo_, mesh), True,
                tracers.fct_bounds_work(
                    2, L, N, ct.fct_slot.shape[0], size,
                    ct.fct_tile_nodes.numel(), ct.tile_nodes), None)]
        nie = mesh.nod_in_elem.long()
        w = mesh.elem_area[nie.clamp_min(0)] * (nie >= 0)
        mean = csr(torch.arange(N, device=dev)[:, None].expand_as(nie)[
            nie >= 0], nie[nie >= 0], (w / w.sum(1, keepdim=True))[nie >= 0],
            (N, E))
        for lev in (False, True):
            x = rand(2, L, E, dtype=dtype)
            xt = x.reshape(-1, E).T.contiguous()
            out.append(("elem_to_node_mean", f"shelf levels={lev} "
                        f"{[2, L, E]}",
                        lambda x=x, lev=lev: ops.elem_to_node_mean(x, mesh,
                                                                   lev),
                        lambda x=x, lev=lev: ops.elem_to_node_mean_plain(
                            x, mesh, lev), True,
                        ops.elem_to_node_mean_work(
                            2, L, E, N, K, size, ct.mean_tile_elems.numel(),
                            ct.tile_nodes),
                        None if lev else (lambda xt=xt: mean @ xt)))
        # bitwise in float64; in float32 a column whose boundary layer
        # rounding moves a level passes as in the globe's case
        args = kpp.column_inputs(st, mesh, m.cfg, forcing)
        out.append(("kpp_column", "shelf dd=False",
                    lambda: tuple(x for x in kpp.kpp_column(*args)
                                  if x is not None),
                    lambda: tuple(x for x in kpp.kpp_column_plain(*args)
                                  if x is not None), dtype == torch.float64,
                    kpp.kpp_column_work(mesh.nl, N, wet, False, size), None))
        out.append(pbv_case("shelf", m, st))
        return out

    def menu_shape_cases(dtype, mesh):
        """The shapes the column-physics menus add on the level-7 globe
        (phase 19): TKE's and IDEMIX's one [nl, N] tridiagonal a step,
        one right-hand side, Neumann rows at the surface and at the
        bottom interface nb, identity rows below it; the six-tracer
        stack's solves (a, b, c [nl-1, N], d [6, nl-1, N]) and bounds.
        (elem_to_node_mean_flat at TKE's surface stress [2, E] is the
        shape phase 3 already times: ``flat [2, E]``.)"""
        size = torch.empty((), dtype=dtype).element_size()
        nl_, N_, L_ = mesh.nl, mesh.n_nodes, mesh.nl - 1
        ct = mesh.cluster
        lev = torch.arange(nl_, device=dev)[:, None]
        nb = (mesh.nlevels_node - 1)[None, :]
        act = lev <= nb
        a = torch.where(act & (lev >= 1),
                        rand(nl_, N_, lo=-0.4, hi=0.0, dtype=dtype), 0.0)
        c = torch.where(lev < nb, rand(nl_, N_, lo=-0.4, hi=0.0,
                                       dtype=dtype), 0.0)
        b = torch.where(act, 1.0 - a - c, 1.0)
        d = torch.where(act, rand(nl_, N_, dtype=dtype), 0.0)
        out = [("tridiag_solve", f"globe tke a,b,c {[nl_, N_]} d "
                f"{[nl_, N_]}",
                lambda: ops.tridiag_solve(a, b, c, d),
                lambda: ops.tridiag_solve_plain(a, b, c, d), True,
                ops.tridiag_solve_work(1, nl_, N_, size), None)]
        a6 = rand(L_, N_, lo=-0.4, hi=0.0, dtype=dtype)
        c6 = rand(L_, N_, lo=-0.4, hi=0.0, dtype=dtype)
        b6 = rand(L_, N_, lo=1.0, hi=2.0, dtype=dtype)
        d6 = rand(6, L_, N_, dtype=dtype)
        out.append(("tridiag_solve", f"globe six a,b,c {[L_, N_]} d "
                    f"{[6, L_, N_]}",
                    lambda: ops.tridiag_solve(a6, b6, c6, d6),
                    lambda: ops.tridiag_solve_plain(a6, b6, c6, d6), True,
                    ops.tridiag_solve_work(6, L_, N_, size), None))
        ttf = rand(6, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
        lo6 = rand(6, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
        out.append(("fct_bounds", f"globe six ttf,lo {[6, L_, N_]}",
                    lambda: tracers.fct_bounds(ttf, lo6, mesh),
                    lambda: tracers.fct_bounds_plain(ttf, lo6, mesh), True,
                    tracers.fct_bounds_work(
                        6, L_, N_, ct.fct_slot.shape[0], size,
                        ct.fct_tile_nodes.numel(), ct.tile_nodes), None))
        return out

    def globe_cases(dtype):
        """The step kernels on the globe's varying-depth tables, then
        pressure_bv and kpp_column on its state after one step, and
        block_schwarz and ring_spmv with the globe's own CG tables (the
        coupled step's; the last case of each, so its row of the
        result)."""
        m, st, f = gm[dtype], g1[dtype], gin[dtype][1]
        mesh = m.mesh
        wet = int(mesh.node_layer_mask.sum())
        out = menu_shape_cases(dtype, mesh)
        out += cases(dtype, "globe", m, st, full=False)
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
    variant_tables = {}  # the EVP and aEVP kernels' tables by dtype
    ecn_calls = {}      # elem_contrib_to_nodes: calls a coupled step by shape

    def ecn_case(label, tables, lead, vertex_major, dtype, calls, site):
        """elem_contrib_to_nodes on contrib [*lead, 3, E] (vertex-major) or
        [*lead, E, 3] of ``tables`` (the mesh or the ice subdomain), with
        its calls a CI coupled step and the call site that gives it;
        library call: a CSR product over the same incidence."""
        size = torch.empty((), dtype=dtype).element_size()
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
        return ("elem_contrib_to_nodes", f"{label} {list(x.shape)}",
                lambda: fn(x, tables),
                lambda: ops.elem_contrib_to_nodes_plain(x, tables,
                                                        vertex_major), True,
                ops.elem_contrib_to_nodes_work(
                    rows, n_e, n_n, tables.nod_in_elem.shape[1], size),
                lambda: inc @ xt)

    def menu_cases(dtype):
        """The shapes the ocean dynamics menus add, on the level-7 globe:
        ring_spmv on the fast configuration's static linfs ring (phase 14
        launches it); elem_contrib_to_nodes at [L, E, 3], every layer
        element-major (the vector-invariant momentum's kinetic energy);
        elem_to_node_mean on one [L, E] field with the level mask (the
        Leith viscosity's smoothing) and without (the backscatter's and
        the UKE's; library call: a CSR product with the area weights)."""
        m = gf[dtype]
        mesh = m.mesh
        L, N, E = mesh.nl - 1, mesh.n_nodes, mesh.n_elems
        K = mesh.nod_in_elem.shape[1]
        size = torch.empty((), dtype=dtype).element_size()
        ct = mesh.cluster
        out = [ring_case("globe linfs (fast)", m, dtype),
               ecn_case("globe", mesh, (L,), False, dtype, 0,
                        "core/dynamics.py compute_vel_rhs_vinv (mom_adv=3; "
                        "not in the CI or the fast step)")]
        nie = mesh.nod_in_elem.long()
        w = mesh.elem_area[nie.clamp_min(0)] * (nie >= 0)
        mean = csr(torch.arange(N, device=dev)[:, None].expand_as(nie)[
            nie >= 0], nie[nie >= 0], (w / w.sum(1, keepdim=True))[nie >= 0],
            (N, E))
        for lev in (True, False):
            x = rand(L, E, dtype=dtype)
            xt = x.T.contiguous()
            out.append(("elem_to_node_mean", f"globe visc levels={lev} "
                        f"{[L, E]}",
                        lambda x=x, lev=lev: ops.elem_to_node_mean(x, mesh,
                                                                   lev),
                        lambda x=x, lev=lev: ops.elem_to_node_mean_plain(
                            x, mesh, lev), False,
                        ops.elem_to_node_mean_work(
                            1, L, E, N, K, size, ct.mean_tile_elems.numel(),
                            ct.tile_nodes),
                        None if lev else (lambda xt=xt: mean @ xt)))
        return out

    def ice_cases(dtype):
        """The sea ice's kernels on the level-7 globe, at its state after
        one coupled step: elem_contrib_to_nodes at the six shapes of the
        step, on the subdomain's tables and on the whole globe (library
        call: a CSR product over the same incidence), and
        mevp_subcycles on the subdomain's tables (the step's subcycles in
        one launch).  The mEVP kernel works in place: it is compared on
        copies and timed on buffers of its own (an eighth item)."""
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
        Ns, Es, Ks = cap.n_nodes, cap.n_elems, cap.elem_slot.shape[0]
        if dtype == torch.float64:
            say(f"phase 3 ice subdomain: {Ns} of {mesh.n_nodes} nodes, {Es} "
                f"of {mesh.n_elems} elements, K={Ks}; nodes with ice "
                f"{int(tab.node_c[12].sum())}, elements with ice "
                f"{int(tab.elem_c[9].sum())}, max|u_ice| "
                f"{float(uv0.abs().max()):.4f} m/s after one coupled step")
        # the six calls of the coupled step, each with the call site that
        # gives it (the last, the largest: the row of the result)
        out = [ecn_case(label, tables, lead, vertex_major, dtype, 1, site)
               for label, tables, lead, vertex_major, site in (
                   ("subdomain", cap, (2,), False, "ice/evp.py mevp_setup"),
                   ("globe", mesh, (6,), True, "ice/fct.py ice_tg_rhs_div"),
                   ("globe", mesh, (6,), False,
                    "ice/fct.py _lumped_iterate, second product"),
                   ("globe", mesh, (2, 3), False, "ice/fct.py ppair"),
                   ("globe", mesh, (3,), False, "ice/fct.py out"),
                   ("globe", mesh, (9,), False,
                    "ice/fct.py _lumped_iterate, first product with the "
                    "low-order fields"))]
        n_sub = m.cfg.ice.evp_rheol_steps
        sig_t, uv_t = sig0.clone(), uv0.clone()
        out.append(("mevp_subcycles", f"subdomain uv {[2, Ns]} sig {[3, Es]} "
                    f"x{n_sub}",
                    lambda: evp.mevp_subcycles(uv0.clone(), sig0.clone(), tab,
                                               cap, n_sub),
                    lambda: evp.mevp_subcycles_plain(uv0, sig0, tab, cap,
                                                     n_sub), True,
                    evp.mevp_subcycles_work(Ns, Es, Ks, size, n_sub), None,
                    lambda: evp.mevp_subcycles(uv_t, sig_t, tab, cap,
                                               n_sub)))
        # the standard- and adaptive-EVP variants of the subcycle kernel on
        # the same state's subdomain tables (aEVP with the state's alpha
        # and beta); no library call computes either function
        with torch.no_grad():
            ice_a, forc_a, surf_a = evp.subdomain_inputs(ice, cap, iforc,
                                                         surf, aevp=True)
            variants = {}
            for which, name, setup_v in ((0, "evp_subcycles", evp.evp_setup),
                                         (2, "aevp_subcycles",
                                          evp.aevp_setup)):
                cfg_v = copy.deepcopy(m.cfg)
                cfg_v.ice.whichEVP = which
                variants[name] = setup_v(ice_a if which == 2 else ice_l, cap,
                                         forc_a if which == 2 else forc_l,
                                         surf_a if which == 2 else surf_l,
                                         cfg_v)
        variant_tables[dtype] = variants
        for name, kern_v, plain_v, work_v in (
                ("evp_subcycles", evp.evp_subcycles, evp.evp_subcycles_plain,
                 evp.evp_subcycles_work),
                ("aevp_subcycles", evp.aevp_subcycles,
                 evp.aevp_subcycles_plain, evp.aevp_subcycles_work)):
            tab_v = variants[name]
            uv_v, sig_v = uv0.clone(), sig0.clone()
            out.append((name, f"subdomain uv {[2, Ns]} sig {[3, Es]} "
                        f"x{n_sub}",
                        lambda k=kern_v, t=tab_v: k(uv0.clone(), sig0.clone(),
                                                    t, cap, n_sub),
                        lambda p=plain_v, t=tab_v: p(uv0, sig0, t, cap,
                                                     n_sub), True,
                        work_v(Ns, Es, Ks, size, n_sub), None,
                        lambda k=kern_v, t=tab_v, u=uv_v, g=sig_v: k(
                            u, g, t, cap, n_sub)))
        return out

    def icepack_model(m, **opts):
        """The Icepack CI model (``cfg.run.use_icepack``, an IcepackConfig
        of ``opts``) on the tables of the CI model ``m``."""
        cfg = copy.deepcopy(m.cfg)
        cfg.run.use_icepack = True
        cfg.icepack = IcepackConfig(**opts)
        return Model(m.mesh, cfg, m.tracer_statics, m.density_ref,
                     ice_sub=m.ice_sub, ssh_dense_inv=m.ssh_dense_inv,
                     ssh_ring=m.ssh_ring, ssh_block_pc=m.ssh_block_pc)

    def icepack_start(m):
        st_, ice_ = pi_initial_state(m)
        return st_, ice_, init_icepack_state(
            m.cfg.icepack, ice_.a_ice, ice_.m_ice, ice_.m_snow, ice_.t_skin,
            dtype=m.dtype)

    def icepack_cases(dtype):
        """The Icepack step's kernels on the level-7 globe, on the inputs
        the second coupled step hands them (the state after one step):
        bl99_temperature_solve on the [5, N] columns (within the tolerance,
        the same sweep count in float64; in float32 a sweep count or a
        melting flag that differs is reported), itd_remap's two calls
        (the remap with the rebin after thermo2, the rebin after ridging;
        bitwise) and mevp_subcycles on the whole mesh with the strength
        field (bitwise).  No PyTorch call computes any of them."""
        if dtype not in icepack_models:
            icepack_models[dtype] = icepack_model(gm[dtype])
        m = icepack_models[dtype]
        step = pi_coupled_step_fn(m, gatm[dtype])
        st_, ice_, ipk_ = icepack_start(m)
        st_, ice_, ipk_, _ = step(st_, ice_, 0, ipk_)
        with icepack_driver.recording_kernel_inputs() as rec:
            step(st_, ice_, 1, ipk_)
        tag = str(dtype).replace("torch.", "")
        size = torch.empty((), dtype=dtype).element_size()
        args, kw = rec["temperature_solve"][0]
        ncat, n_nodes = args[1].shape
        got = tvert.temperature_solve(*args, **kw)
        want = tvert.temperature_solve_plain(*args, **kw)
        n_k, n_p = int(got["niter"]), int(want["niter"])
        melt = int((got["melting"] != want["melting"]).sum())
        bl99_report[tag] = {"sweeps_kernel": n_k, "sweeps_plain": n_p,
                            "melting_columns_differ": melt,
                            "melting_columns": int(want["melting"].sum()),
                            "plan": tvert.bl99_plan(dev, dtype,
                                                    ncat * n_nodes)}
        say(f"phase 3 bl99_temperature_solve {tag}: {ncat} x {n_nodes} "
            f"columns, sweeps kernel {n_k} plain {n_p}, columns melting "
            f"{bl99_report[tag]['melting_columns']}, melting flags that "
            f"differ {melt}; launch {bl99_report[tag]['plan']}")
        if dtype == torch.float64 and (n_k != n_p or melt):
            fail(f"bl99_temperature_solve float64: sweeps {n_k} against the "
                 f"plain version's {n_p}, {melt} melting flags differ")
        outs = ("Tsf", "Tsn", "Tin", "fsurf", "fcondtop", "fcondbot",
                "fsens", "flat", "flwout")
        pick = lambda sol: tuple(sol[k] for k in outs)
        out = [("bl99_temperature_solve",
                f"level-7 Icepack columns [{ncat}, {n_nodes}] x{n_p} sweeps",
                lambda: pick(tvert.temperature_solve(*args, **kw)),
                lambda: pick(tvert.temperature_solve_plain(*args, **kw)),
                False,
                tvert.temperature_solve_work(
                    ncat, n_nodes, args[0].nilyr, args[0].nslyr, size, n_p,
                    kw.get("shcoef") is not None, args[0].conduct),
                None)]
        # the rebin after ridging, then the remap after thermo2 (the larger
        # call: a kernel's last float64 case stands for it in the summary);
        # the kernel reads the category tensors and writes a new pack
        for a, _ in reversed(rec["itd_remap"]):
            nc, nn = a[0].shape
            rows = 4 + sum(x.shape[1] for x in a[4:8])
            what = "remap + rebin" if a[-1] else "rebin"
            plan = icepack_itd.itd_remap_plan(dev, dtype, nc, nn, a[-1])
            summary["itd_remap"].setdefault("plan", {})[
                f"{tag} {what}"] = plan
            say(f"phase 3 itd_remap {tag} {what}: launch {plan}")
            out.append(("itd_remap", f"{what} pack {[nc, rows, nn]}",
                        lambda a=a: icepack_itd.itd_remap(*a),
                        lambda a=a: icepack_itd.itd_remap_plain(*a), True,
                        icepack_itd.itd_remap_work(nc, rows, nn, size,
                                                   a[-1]), None))
        (ice_d, mesh_d, forc_d, surf_d, cfg_d), kw_d = \
            rec["ice_dynamics"][0]
        tab = evp.mevp_setup(ice_d, mesh_d, forc_d, surf_d, cfg_d,
                             strength_node=kw_d["strength_node"])
        uv0 = torch.stack([ice_d.u_ice, ice_d.v_ice])
        sig0 = torch.stack([ice_d.sigma11, ice_d.sigma12, ice_d.sigma22])
        Nw, Ew = mesh_d.n_nodes, mesh_d.n_elems
        Kw = mesh_d.cluster.elem_slot.shape[0]
        n_sub = cfg_d.ice.evp_rheol_steps
        # the latency floor of the whole-mesh grid's barriers (an empty
        # kernel on the same grid), beside the subdomain's
        nb_w = evp.mevp_subcycles_barriers(n_sub)
        plan_w = evp.mevp_subcycles_plan(dev, dtype, Nw, Ew, Kw, "mevp")
        floor_w = device_us(lambda: evp.mevp_barrier_floor(
            dev, dtype, Nw, Ew, Kw, nb_w, "mevp"), calls=5)
        say(f"phase 3 mevp_subcycles {tag} whole mesh uv {[2, Nw]} sig "
            f"{[3, Ew]} {n_sub} subcycles: plan {plan_w}, latency floor "
            f"({nb_w} grid barriers, an empty kernel on the same grid) "
            f"device_us={us_text(floor_w)} ({card})")
        summary["mevp_subcycles"].setdefault("whole_mesh_plan", {})[tag] = \
            plan_w
        summary["mevp_subcycles"].setdefault(
            "whole_mesh_barrier_floor_ms", {})[tag] = floor_w and floor_w / 1e3
        uv_t, sig_t = uv0.clone(), sig0.clone()
        out.append(("mevp_subcycles", f"whole mesh with the Icepack strength "
                    f"uv {[2, Nw]} sig {[3, Ew]} x{n_sub}",
                    lambda: evp.mevp_subcycles(uv0.clone(), sig0.clone(),
                                               tab, mesh_d, n_sub),
                    lambda: evp.mevp_subcycles_plain(uv0, sig0, tab, mesh_d,
                                                     n_sub), True,
                    evp.mevp_subcycles_work(Nw, Ew, Kw, size, n_sub), None,
                    lambda: evp.mevp_subcycles(uv_t, sig_t, tab, mesh_d,
                                               n_sub)))
        return out

    def dmoc_cases(dtype):
        """dens_moc_bin on the level-7 globe after one coupled step: the
        interface densities and the layers of the state the output path
        bins (no bolus velocities, as diag_dens_moc takes it there), each
        of the five outputs against the plain version (its [nl-1, S,
        chunk] chain over chunks of elements); no PyTorch call computes
        the binning."""
        m, atm = gm[dtype], gatm[dtype]
        mesh = m.mesh
        st, ice = pi_initial_state(m)
        st, _, _ = pi_coupled_step_fn(m, atm)(st, ice, 0)
        dens = diagnostics.interface_density(st, mesh, m.cfg)
        bins = torch.as_tensor(diagnostics.STD_DENS, device=dev).to(dtype)
        args = (dens, st.helem, st.u, st.v, mesh.elem_area,
                mesh.ulevels_elem, mesh.nlevels_elem, bins)
        counts = diagnostics.dens_moc_bin_counts(dens, mesh.ulevels_elem,
                                                 mesh.nlevels_elem, bins)
        size = torch.empty((), dtype=dtype).element_size()
        if dtype == torch.float64:
            widths = np.asarray(counts[4])
            cum = np.cumsum(widths)
            pick = lambda f: int(np.searchsorted(cum, f * cum[-1]))
            dmoc_counts.update(active_layers=counts[0],
                               run_classes=counts[1],
                               nearest_layers=counts[2],
                               wet_elements=counts[3],
                               span_widths={w: int(n) for w, n in
                                            enumerate(widths) if n},
                               plan=diagnostics.dens_moc_bin_plan(
                                   dtype, bins.numel()))
            say(f"phase 3 dens_moc_bin inputs: {mesh.nl} levels x "
                f"{mesh.n_elems} elements, {bins.numel()} classes; active "
                f"layers {counts[0]}, classes in their runs {counts[1]}, "
                f"layers binned to the nearest class {counts[2]}, elements "
                f"with an active layer {counts[3]}; span widths in classes "
                f"(median {pick(0.5)}, 90 % {pick(0.9)}, max "
                f"{int(np.flatnonzero(widths).max())}) "
                f"{dmoc_counts['span_widths']}; launch "
                f"{dmoc_counts['plan']}")
        return [("dens_moc_bin",
                 f"level-7 globe [5, {bins.numel()}, {mesh.n_elems}]",
                 lambda: tuple(diagnostics.dens_moc_bin(*args)),
                 lambda: tuple(diagnostics.dens_moc_bin_plain(*args)),
                 False, diagnostics.dens_moc_bin_work(
                     mesh.n_elems, bins.numel(), size, *counts[:4], False),
                 None)]

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
    sub = {torch.float64: build_mesh(sub_path, force_rotation=True,
                                     cyclic_length_deg=360.0,
                                     use_partial_cell=True,
                                     dtype=torch.float64, device=dev)}
    # build_mesh computes in float64 and rounds at the end: the float32
    # tables are these, cast (tests/test_torch_globe.py holds the two
    # equal), one build fewer
    from fesom2_tpu_torch.parallel.dist import tree_map
    sub[torch.float32] = tree_map(
        lambda t: t.to(torch.float32) if t.is_floating_point() else t,
        sub[torch.float64])
    say(f"phase 3 level-7 globe in subdivision numbering written and its "
        f"tables built in {time.perf_counter() - t0:.2f} s")
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
                + menu_cases(dtype) + shelf_cases(dtype) + globe_cases(dtype)
                + icepack_cases(dtype) + ice_cases(dtype)
                + dmoc_cases(dtype)):
            # an in-place kernel is timed on buffers of its own
            kern_t = own[0] if own else kern
            # the plain versions of the subcycle loops (some 5,400 eager
            # ops a call) and of the Icepack kernels (a host read a BL99
            # sweep; some 1,500 eager ops a remap) are timed over fewer
            # calls
            light = name.endswith("_subcycles") \
                or name in ("bl99_temperature_solve", "itd_remap",
                            "dens_moc_bin")
            t_case = time.perf_counter()
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_abs(g, w) for g, w in zip(got, want))
            # each output against its own largest magnitude
            rel = max(max_abs(g, w) / max(float(w.abs().max()), 1e-300)
                      for g, w in zip(got, want))
            bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
            ok = bitwise if exact else rel <= tol
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
            p_ms = timed(plain, reps=3, warmup=1) if light else timed(plain)
            l_ms = timed(library) if library is not None else None
            b_ms, bound_by = kernels.bound_ms(work, dtype)
            k_dev, l_dev = device_us(kern_t), None
            if library is not None:
                l_dev = device_us(library)
            say(f"phase 3 {name:21s} {tag} {label:36s} max_abs_err={err:.3e} "
                f"rel={rel:.3e} bitwise={bitwise} "
                f"kernel_us={k_ms * 1e3:.1f} plain_us={p_ms * 1e3:.1f} "
                f"library_us={'none' if l_ms is None else f'{l_ms * 1e3:.1f}'} "
                f"bound_us={b_ms * 1e3:.1f} ({bound_by}) "
                f"device: kernel_us={us_text(k_dev)} "
                f"library_us={'none' if library is None else us_text(l_dev)}"
                f" ({time.perf_counter() - t_case:.1f} s)")
            # every shape of the kernels whose step calls take several
            if (name in ("tridiag_solve", "elem_to_node_mean")
                    and label.startswith("globe")) \
                    or " six " in label \
                    or label.startswith("shelf") \
                    or name in ("block_schwarz", "elem_contrib_to_nodes",
                                "kpp_column", "ring_spmv",
                                "mevp_subcycles", "itd_remap"):
                summary[name].setdefault("shapes", {})[f"{tag} {label}"] = {
                    "ms": k_ms, "device_ms": k_dev and k_dev / 1e3,
                    "bitwise": bitwise,
                    "bound_ms": b_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "library_device_ms": l_dev and l_dev / 1e3,
                    **ecn_calls.get(label, {}),
                    **schwarz_padded.get((dtype, label), {})}
            if (dtype, label) in schwarz_padded:
                say(f"phase 3 block_schwarz {tag} {label}: packed bound "
                    f"{b_ms * 1e3:.1f} us beside the padded tables' "
                    f"{schwarz_padded[(dtype, label)]['padded_bound_ms'] * 1e3:.1f}"
                    f" us; " + json.dumps(schwarz_padded[(dtype, label)]))
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

    # the subcycle kernel's three rheologies against their plain loops after
    # 1, 8 and 120 subcycles, from the ice state after one coupled step;
    # each variant's launch plan and the latency floor of its grid barriers
    subcycle_variants = (
        ("mevp_subcycles", "mevp", evp.mevp_subcycles,
         evp.mevp_subcycles_plain),
        ("evp_subcycles", "evp", evp.evp_subcycles, evp.evp_subcycles_plain),
        ("aevp_subcycles", "aevp", evp.aevp_subcycles,
         evp.aevp_subcycles_plain))
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        tab, uv0, sig0, cap = ice_tables[dtype]
        Ns, Es, Ks = cap.n_nodes, cap.n_elems, cap.elem_slot.shape[0]
        n_sub = gm[dtype].cfg.ice.evp_rheol_steps
        nb = evp.mevp_subcycles_barriers(n_sub)
        for name, rheo, kern_v, plain_v in subcycle_variants:
            tab_v = tab if rheo == "mevp" else variant_tables[dtype][name]
            for n in (1, 8, 120):
                uv_p, sig_p = plain_v(uv0, sig0, tab_v, cap, n)
                uv_k, sig_k = kern_v(uv0.clone(), sig0.clone(), tab_v, cap, n)
                torch.cuda.synchronize()
                bitwise = torch.equal(uv_k, uv_p) and torch.equal(sig_k,
                                                                  sig_p)
                moved = float((uv_p - uv0).abs().max())
                say(f"phase 3 {name} {tag} {n} subcycles: bit-equal to the "
                    f"plain loop: {bitwise} (uv {max_abs(uv_k, uv_p):.3e}, "
                    f"sig {max_abs(sig_k, sig_p):.3e}); the velocities moved "
                    f"by {moved:.3e} m/s")
                if not (bitwise and moved > 0.0):
                    fail(f"phase 3: {name} {tag} after {n} subcycles is not "
                         f"the plain loop")
            plan = evp.mevp_subcycles_plan(dev, dtype, Ns, Es, Ks, rheo)
            floor_us = device_us(lambda: evp.mevp_barrier_floor(
                dev, dtype, Ns, Es, Ks, nb, rheo), calls=5)
            say(f"phase 3 {name} {tag} {n_sub} subcycles: plan {plan}, "
                f"latency floor ({nb} grid barriers, an empty kernel on the "
                f"same grid) device_us={us_text(floor_us)} ({card})")
            summary[name].setdefault("plan", {})[tag] = plan
            summary[name].setdefault("barrier_floor_ms", {})[tag] = (
                floor_us and floor_us / 1e3)

    # the three gather kernels on both numberings of the level-7 globe:
    # held against plain on the subdivision numbering too, then timed once
    # on each (a comparison of the two needs turns: curve, subdivision,
    # subdivision, curve): the profiler's device us, and us per call of 20
    # calls between one pair of events
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        tag = str(dtype).replace("torch.", "")
        timings = {}
        for turn, (label, mesh) in enumerate((
                ("curve", gm[dtype].mesh), ("subdivision", sub[dtype]))):
            L_, N_, E_, Ed_ = (mesh.nl - 1, mesh.n_nodes, mesh.n_elems,
                               mesh.n_edges)
            f = rand(2, L_, Ed_, dtype=dtype)
            x = rand(2, L_, E_, dtype=dtype)
            ttf = rand(2, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
            lo_ = rand(2, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
            for name, kern, plain, exact in (
                    ("node_edge_reduce div",
                     lambda: ops.edge_divergence(f, mesh),
                     lambda: ops.edge_divergence_plain(f, mesh), True),
                    ("node_edge_reduce pair",
                     lambda: ops.edge_signed_reduce2(f, mesh),
                     lambda: ops.edge_signed_reduce2_plain(f, mesh), True),
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
    phase_start(4, t_start)
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
    phase_start(5, t_start)
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
    phase_start(6, t_start)
    # the step is host-bound, so its rate drifts with the shared host: the
    # two dtypes are measured one after the other
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
    phase_start(7, t_start)
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
    phase_start(8, t_start)
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
    phase_start(9, t_start)
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
    phase_start(10, t_start)
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
    phase_start(11, t_start)
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
    phase_start(12, t_start)
    ice_kernels = ("elem_contrib_to_nodes", "mevp_subcycles")
    coupled_kernels = ci_kernels + ice_kernels
    atm64 = gatm[torch.float64]
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
    check_ice("phase 12", m64, st, ice, ice0)
    retired = [k for k in ("mevp_stress", "mevp_node")
               if k in kernels.LAUNCHES]
    say(f"phase 12 the retired pair mevp_stress, mevp_node: "
        f"{retired or 'no longer kernels, never launched'}")
    if retired:
        fail(f"phase 12: the retired mEVP kernels are still kernels: {retired}")
    step_calls = {"pressure_bv": 1, "tridiag_solve": 4, "kpp_column": 1,
                  "elem_contrib_to_nodes": 6, "mevp_subcycles": 1}
    for k, want in step_calls.items():
        if per_coupled_step[k] != want:
            fail(f"phase 12: {k} launched {per_coupled_step[k]} times a "
                 f"step, not {want}")
    for k in ice_kernels:
        path_launches[k] = launches[k]

    cruns, ci_rates = {}, {}
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
            ci_rates[str(dtype).replace('torch.', '')] = n / wall
            # the next 10 steps as a bare loop of the step, without
            # run_pi's blowup scan and its flag reads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bare = pi_coupled_step_fn(mdl, gatm[dtype])
            for k in range(k0 + n, k0 + 2 * n):
                s_, i_, _ = bare(s_, i_, k)
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - t0
            cruns[dtype][1:] = [s_, i_, k0 + 2 * n]
            say(f"phase 12 blowup scan {str(dtype).replace('torch.', '')}: "
                f"run_pi {n / wall:.3f} coupled steps/s, the bare step loop "
                f"after it {n / wall_b:.3f} ({card})")
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    from fesom2_tpu_torch.core.diag import check_blowup, first_bad_step
    for dtype, (mdl, s_, i_, _) in cruns.items():
        # the scan alone, as run_pi queues it after each step
        first = torch.full((), -1, dtype=torch.int32, device=dev)

        def scan(j=1):
            return first_bad_step(check_blowup(s_, mdl.mesh, i_,
                                               mdl.ice_sub), first, j)
        scan_us = device_us(scan)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            scan()
            torch.cuda.synchronize()
        n_ops = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        reps = 50
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(reps):
            first = scan(j)
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        if int(first) >= 0:
            fail("phase 12: the blowup scan flags a sane state")
        say(f"phase 12 blowup scan alone {str(dtype).replace('torch.', '')}"
            f": {n_ops} device ops, {host_ms:.4f} host ms and "
            f"{us_text(scan_us)} device us a scan ({card})")
    # the 3-step profiles, each dtype's launches a coupled step counted in
    # them (the CG kernels' with the CG iterations of each dtype's steps)
    step_us, launches_dtype = {}, {}
    # device ms a step per span, by path and dtype
    span_ms = {"ci": {}, "fast": {}, "shelf": {}}
    for dtype, (mdl, s_, i_, k0) in cruns.items():
        tag = str(dtype).replace("torch.", "")
        kernels.reset_launches()
        step_us[tag] = profile_steps(
            "phase 12", mdl, s_, 3, card,
            run=lambda m, st_, k, a=gatm[dtype], i=i_, k0=k0:
            run_pi(m, a, st_, i, k, first_step=k0),
            also=("mevp", "elem_contrib", "elem_to_node_mean", "pressure_bv",
                  "tridiag_solve"), spans=span_ms["ci"].setdefault(tag, {}))
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
    functions["block_schwarz"] = ("::schwarz_local_kernel<",
                                  "::schwarz_combine_kernel<")
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
    # one SSH solve on each dtype's level-7 CI state, preconditioned by the
    # kernel and by the plain version on the padded tables: the same CG
    # iterations, d_eta within 1e-9 of max|d_eta| (float32: 1e-3, CG to
    # 2e-5 under two roundings of the preconditioner)
    from fesom2_tpu_torch.core import dynamics
    solve_check = {}
    for dtype, (mdl, s_, i_, _) in cruns.items():
        tag = str(dtype).replace("torch.", "")
        f_ = gin[dtype][1]
        _, u_rhs, v_rhs = dynamics.compute_vel_rhs(s_, mdl.mesh, f_, mdl.cfg)
        rhs = ssh.compute_ssh_rhs(s_, mdl.mesh, mdl.cfg, f_, u_rhs, v_rhs)
        pc = mdl.ssh_block_pc
        x0 = 2.0 * s_.d_eta - s_.d_eta_prev
        kernels.reset_launches()
        d_k, it_k, res_k = ssh.solve_ssh(s_, mdl.mesh, mdl.cfg, pc, rhs,
                                         mdl.ssh_ring, x0=x0)
        n_k = kernels.LAUNCHES["block_schwarz"]
        kernels.reset_launches()
        d_p, it_p, res_p = ssh.solve_ssh(
            s_, mdl.mesh, mdl.cfg,
            lambda r, pc=pc: ops.halo_accumulate_nodes(
                ssh.block_schwarz_plain(pc, r)), rhs, mdl.ssh_ring, x0=x0)
        n_p = kernels.LAUNCHES["block_schwarz"]
        rel = max_abs(d_k, d_p) / max(float(d_p.abs().max()), 1e-300)
        tol = 1e-9 if dtype == torch.float64 else 1e-3
        solve_check[tag] = dict(iterations=[int(it_k), int(it_p)],
                                residual=[float(res_k), float(res_p)],
                                rel=rel, launches=[n_k, n_p])
        say(f"phase 12 SSH solve {tag} on the level-7 CI state: kernel "
            f"{int(it_k)} CG iterations ({n_k} launches, residual "
            f"{float(res_k):.3e}), plain preconditioner {int(it_p)} "
            f"({float(res_p):.3e}); d_eta {rel:.3e} of max|d_eta| apart "
            f"(tol {tol:.0e})")
        if int(it_k) != int(it_p) or not rel <= tol or n_k < int(it_k) \
                or n_p != 0 or not torch.isfinite(d_k).all():
            fail(f"phase 12: the SSH solve with the kernel against the plain "
                 f"preconditioner {solve_check[tag]}")
    summary["block_schwarz"]["solve_kernel_vs_plain"] = solve_check
    # the subcycle loop of one step as the step runs it: one launch of
    # mevp_subcycles, wall ms by the host clock (to the synchronise after
    # it), ms between CUDA events around it and device ms by the profiler
    n_sub = m64.cfg.ice.evp_rheol_steps
    loop_ms = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        tab, uv0, sig0, cap = ice_tables[dtype]
        uv_t, sig_t = uv0.clone(), sig0.clone()

        def loop(uv=uv_t, sig=sig_t, tab=tab, cap=cap):
            evp.mevp_subcycles(uv, sig, tab, cap, n_sub)
        loop()
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[len(walls) // 2]
        ev_ms = timed(loop, reps=10, warmup=2)
        dev_us = device_us(loop, calls=5)
        loop_ms[tag] = {"wall_ms": wall, "events_ms": ev_ms,
                        "device_ms": dev_us and dev_us / 1e3}
        say(f"phase 12 subcycle loop {tag}: {n_sub} subcycles in 1 launch of "
            f"mevp_subcycles take {wall:.3f} ms a step by the host clock, "
            f"{ev_ms:.3f} ms between CUDA events around the call, device "
            f"{us_text(dev_us and dev_us / 1e3)} ms by the profiler ({card})")
    summary["mevp_subcycles"]["loop_ms_a_step"] = loop_ms

    # phase 13 -----------------------------------------------------------
    phase_start(13, t_start)
    for label, limit in (("dense", dense_max_saved), ("CG forced", 0)):
        port_model.DENSE_SSH_MAX_NODES = limit
        try:
            on_gpu, atm_gpu = setup_pi_model(small, device=dev)
            on_cpu, atm_cpu = setup_pi_model(small, device="cpu")
        finally:
            port_model.DENSE_SSH_MAX_NODES = dense_max_saved
        kernels.reset_launches()
        s_gpu, i_gpu = run_pi(on_gpu, atm_gpu, *pi_initial_state(on_gpu), 3)
        n_evp = kernels.LAUNCHES["mevp_subcycles"]
        s_cpu, i_cpu = run_pi(on_cpu, atm_cpu, *pi_initial_state(on_cpu), 3)
        say(f"phase 13 level-3 globe ({on_cpu.mesh.n_nodes} nodes, subdomain "
            f"{on_cpu.ice_sub.n_nodes}), {label}: CG iterations of the 3rd "
            f"step card {on_gpu.ssh_iters}, cpu {on_cpu.ssh_iters}; nodes "
            f"with ice {int((i_cpu.a_ice > 0).sum())}, max|u_ice| "
            f"{float(i_cpu.u_ice.abs().max()):.4e}, mevp_subcycles launches "
            f"on the card {n_evp}")
        if kernels.LAUNCHES["mevp_subcycles"] != n_evp or n_evp != 3:
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

    # phase 14 -----------------------------------------------------------
    phase_start(14, t_start)
    # the fast configuration's coupled step at full width: linfs + PP, full
    # cells, no GM/Redi, the same ice; no kpp_column, and tridiag_solve
    # without the GM streamfunction's solve
    fast_kernels = tuple(k for k in coupled_kernels if k != "kpp_column")
    fwet = int(gf[torch.float64].mesh.node_layer_mask.sum())
    for dtype, sec in gf_setup.items():
        say(f"phase 14 setup {str(dtype).replace('torch.', '')}: {sec:.3f} s "
            f"(N={gmesh.n_nodes} ocean nodes, {fwet} wet node-levels, full "
            f"cells: mesh tables, tracer statics, reference density, block "
            f"preconditioner, linfs ring "
            f"{list(gf[dtype].ssh_ring.cols.shape)}, ice subdomain)")
    fm64 = gf[torch.float64]
    stepf = pi_coupled_step_fn(fm64, gfatm[torch.float64])
    st, ice = pi_initial_state(fm64)
    ice0 = ice
    kernels.reset_launches()
    iters = []
    t0 = time.perf_counter()
    for k in range(20):
        st, ice, oforc = stepf(st, ice, k)
        iters.append(fm64.ssh_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    per_fast_step = {k: v / 20 for k, v in launches.items()}
    say(f"phase 14 fast coupled step, 20 steps float64: {wall:.3f} s, CG "
        f"iterations per step {iters}, launches per step {per_fast_step}; "
        f"max|virtual_salt| {float(oforc.virtual_salt.abs().max()):.3e}")
    # linfs: the freshwater flux is a virtual salt flux, the volume stays
    check_globe("phase 14", fm64, st, {k: launches[k] for k in fast_kernels})
    check_ice("phase 14", fm64, st, ice, ice0)
    if launches["kpp_column"]:
        fail("phase 14: kpp_column launched under PP")
    fast_calls = {"pressure_bv": 1, "mevp_subcycles": 1,
                  "elem_contrib_to_nodes": 6}
    for k, want in fast_calls.items():
        if per_fast_step[k] != want:
            fail(f"phase 14: {k} launched {per_fast_step[k]} times a step, "
                 f"not {want}")
    fruns = {}
    for dtype, m in gf.items():
        s_, i_ = pi_initial_state(m)
        s_, i_ = run_pi(m, gfatm[dtype], s_, i_, 2)
        fruns[dtype] = [m, s_, i_, 2]
    for _ in range(2):
        for dtype in (torch.float32, torch.float64):
            mdl, s_, i_, k0 = fruns[dtype]
            n, its = 10, 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(n):
                s_, i_ = run_pi(mdl, gfatm[dtype], s_, i_, 1,
                                first_step=k0 + k)
                its += mdl.ssh_iters
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fruns[dtype][1:] = [s_, i_, k0 + n]
            if not (torch.isfinite(s_.eta).all()
                    and torch.isfinite(i_.u_ice).all()):
                fail("phase 14: eta or u_ice is not finite")
            say(f"phase 14 throughput {str(dtype).replace('torch.', '')}: "
                f"{n / wall:.3f} coupled steps/s, {fwet * n / wall:.6e} wet "
                f"node-levels/s ({fwet} wet node-levels; {its / n:.1f} CG "
                f"iterations/step; {card})")
    fast_us, fast_launches = {}, {}
    for dtype, (mdl, s_, i_, k0) in fruns.items():
        tag = str(dtype).replace("torch.", "")
        kernels.reset_launches()
        fast_us[tag] = profile_steps(
            "phase 14", mdl, s_, 3, card,
            run=lambda m, st_, k, a=gfatm[dtype], i=i_, k0=k0:
            run_pi(m, a, st_, i, k, first_step=k0),
            also=("elem_to_node_mean", "pressure_bv", "tridiag_solve",
                  "ring_spmv", "block_schwarz"),
            spans=span_ms["fast"].setdefault(tag, {}))
        fast_launches[tag] = {k: kernels.LAUNCHES[k] / 3 for k in kernels.KERNELS}
        say(f"phase 14 launches per coupled step {tag} (the profiled 3 "
            f"steps; CG iterations of the last {mdl.ssh_iters}): "
            f"{fast_launches[tag]}")
        idle = [k for k in fast_kernels if fast_launches[tag][k] <= 0]
        if idle or fast_launches[tag]["kpp_column"]:
            fail(f"phase 14 {tag}: kernels of the path never launched {idle}"
                 f", or kpp_column launched")
    fast_ms = {tag: {k: sum(v for key, v in us.items()
                            if any(f in key for f in functions[k])) / 1e3
                     or None for k in fast_kernels}
               for tag, us in fast_us.items()}
    say(f"phase 14 device ms a coupled step per kernel (profile): {fast_ms}")
    for path_name, by_tag in span_ms.items():
        for tag, spans in by_tag.items():
            say(f"device ms a step per span, {path_name} coupled step, {tag}"
                f" ({card}): {json.dumps(spans)}")

    # phase 15 -----------------------------------------------------------
    phase_start(15, t_start)
    # the menus, card against CPU on the level-3 globe (the channel for the
    # forms that need full-cell linfs), 3 float64 steps each
    def menu_cfg(parity, ocean_only, **knobs):
        cfg = port_model.pi_config(parity)
        cfg.run.use_ice = not ocean_only
        for k, v in knobs.items():
            sec = "ale" if k in ("which_ALE", "use_partial_cell") else \
                "run" if k == "use_floatice" else "dyn"
            setattr(getattr(cfg, sec), k, v)
        return cfg

    menus = [("fast parity, dense", menu_cfg("fast", False), dense_max_saved),
             ("fast parity, CG forced", menu_cfg("fast", False), 0),
             ("zlevel (CI ocean)", menu_cfg("ci", True, which_ALE="zlevel"),
              dense_max_saved),
             ("use_floatice under zstar (CI coupled)",
              menu_cfg("ci", False, use_floatice=True), dense_max_saved),
             ("mom_adv=3 (CI ocean)", menu_cfg("ci", True, mom_adv=3),
              dense_max_saved)]
    menus += [(f"visc_option={o} (CI ocean)",
               menu_cfg("ci", True, visc_option=o), dense_max_saved)
              for o in (1, 2, 3, 4, 6, 7, 8)]
    menus += [(f"which_pgf={w} (CI ocean, zstar)",
               menu_cfg("ci", True, which_pgf=w), dense_max_saved)
              for w in ("cubicspline", "easypgf")]
    menus += [(f"which_pgf={w} (linfs, partial cells, ocean)",
               menu_cfg("fast", True, use_partial_cell=True, which_pgf=w),
               dense_max_saved)
              for w in ("nemo", "shchepetkin", "cubicspline", "easypgf")]
    menus += [(f"which_pgf={w} (soufflet channel, linfs full cells)",
               ("soufflet", w), dense_max_saved)
              for w in ("nemo", "cubicspline")]
    menu_report = {}
    t15 = time.perf_counter()
    for label, cfg, limit in menus:
        port_model.DENSE_SSH_MAX_NODES = limit
        try:
            if isinstance(cfg, tuple):
                scfg = port_model.soufflet_config()
                scfg.dyn.which_pgf = cfg[1]
                pair = [setup_soufflet_model(device=d, cfg=scfg)
                        for d in (dev, "cpu")]
            else:
                pair = [setup_pi_model(small, device=d, cfg=cfg)
                        for d in (dev, "cpu")]
        finally:
            port_model.DENSE_SSH_MAX_NODES = dense_max_saved
        kernels.reset_launches()
        outs = []
        for i, obj in enumerate(pair):
            if isinstance(cfg, tuple):
                _, s_, _ = run_soufflet(3, model=obj, verbose=False)
                outs.append((s_, None))
            elif cfg.run.use_ice:
                m, atm = obj
                outs.append(run_pi(m, atm, *pi_initial_state(m), 3))
            else:
                m = obj[0]
                outs.append((run_pi_ocean(m, *globe_ocean_inputs(m), 3), None))
            if i == 0:
                n_card = sum(kernels.LAUNCHES.values())
        if n_card <= 0 or sum(kernels.LAUNCHES.values()) != n_card:
            fail(f"phase 15: {label}: the card's path launched no kernel, or "
                 f"the CPU path launched one")
        (s_gpu, i_gpu), (s_cpu, i_cpu) = outs
        names = ["u", "v", "eta", "hbar", "tr", "w", "hnode", "pgf_x"]
        if "visc_option=8" in label:
            names.append("uke")
        checks = [(s_gpu, s_cpu, names)]
        if i_cpu is not None:
            checks.append((i_gpu, i_cpu, ("u_ice", "v_ice", "m_ice", "a_ice",
                                          "sigma11")))
        worst = 0.0
        for obj_gpu, obj_cpu, fields in checks:
            for name in fields:
                ref = getattr(obj_cpu, name)
                rel = max_abs(getattr(obj_gpu, name).cpu(), ref) \
                    / max(float(ref.abs().max()), 1e-300)
                if not rel <= 1e-8:
                    fail(f"phase 15: {label} {name} card vs CPU {rel:.3e} "
                         f"> 1e-8")
                worst = max(worst, rel)
        iters = pair[0][0].ssh_iters if isinstance(pair[0], tuple) \
            else pair[0].ssh_iters
        menu_report[label] = worst
        say(f"phase 15 {label}: worst field card vs cpu {worst:.3e} of "
            f"max|cpu| over {names}{' and the ice' if i_cpu is not None else ''}"
            f"; {n_card} kernel launches on the card; CG iterations of the "
            f"3rd step {iters}")
    say(f"phase 15 {len(menus)} menu cases in "
        f"{time.perf_counter() - t15:.1f} s")

    # phase 16 -----------------------------------------------------------
    phase_start(16, t_start)
    # the CI coupled step under the ice shelf at full width: the models of
    # phase 3 (setup_pi_model(cavity_depth=globe.shelf_draft(...)))
    sm64 = sm[torch.float64]
    cav_n, cav_e = smesh.ulevels_node > 1, smesh.ulevels_elem > 1
    uln0 = smesh.ulevels_node.long() - 1
    top_area = torch.gather(smesh.areasvol, 0, uln0[None])[0]
    swet = int(smesh.node_layer_mask.sum())
    for dtype, sec in sm_setup.items():
        say(f"phase 16 setup {str(dtype).replace('torch.', '')}: {sec:.3f} s "
            f"(N={smesh.n_nodes}, {int(cav_n.sum())} cavity nodes, "
            f"{int(cav_e.sum())} cavity elements, {swet} wet node-levels; "
            f"the mesh's cavity levels, then as phase 12)")
    steps = pi_coupled_step_fn(sm64, satm[torch.float64])
    st, ice = pi_initial_state(sm64)
    ice0 = ice
    kernels.reset_launches()
    iters, hbar_expected, melt = [], 0.0, 0.0
    t0 = time.perf_counter()
    for k in range(10):
        st, ice, oforc = steps(st, ice, k)
        iters.append(sm64.ssh_iters)
        # the water flux enters each column through its top row
        hbar_expected = hbar_expected - sm64.cfg.dt * (
            oforc.water_flux * top_area).sum() / top_area.sum()
        melt = max(melt, float(oforc.heat_flux[cav_n].abs().max()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shelf_launches = {k: kernels.LAUNCHES[k] for k in coupled_kernels}
    per_shelf_step = {k: v / 10 for k, v in shelf_launches.items()}
    say(f"phase 16 coupled CI step under the shelf, 10 steps float64: "
        f"{wall:.3f} s, CG iterations per step {iters}, launches per step "
        f"{per_shelf_step}")
    check_globe("phase 16", sm64, st, shelf_launches, float(hbar_expected),
                area=top_area)
    check_ice("phase 16", sm64, st, ice, ice0, n_steps=10)
    for k, want in step_calls.items():
        if per_shelf_step[k] != want:
            fail(f"phase 16: {k} launched {per_shelf_step[k]} times a step, "
                 f"not {want}")
    lay = torch.arange(smesh.nl - 1, device=dev)[:, None]
    above_n = lay < uln0[None]
    above_e = lay < (smesh.ulevels_elem.long() - 1)[None]
    nonzero_above = {name: int((f[above] != 0).sum()) for name, f, above in (
        ("T", st.tr[0], above_n), ("S", st.tr[1], above_n),
        ("density_m_rho0", st.density_m_rho0, above_n),
        ("hpressure", st.hpressure, above_n), ("u", st.u, above_e),
        ("v", st.v, above_e))}
    ice_under = float(torch.maximum(ice.a_ice[cav_n].abs().max(),
                                    ice.m_ice[cav_n].abs().max()))
    T_top = torch.gather(st.tr[0], 0, uln0[None])[0]
    # cavity nodes under the draft, and those the cavity levels put at
    # coastal corners elsewhere (ROADMAP queue 3)
    drafted = torch.as_tensor(draft7 < 0, device=dev)
    for where, sel in (("under the draft", cav_n & drafted),
                       ("off the draft", cav_n & ~drafted)):
        if not bool(sel.any()):
            continue
        say(f"phase 16 cavity nodes {where}: {int(sel.sum())}; last step's "
            f"melt heat flux in [{float(oforc.heat_flux[sel].min()):.3f}, "
            f"{float(oforc.heat_flux[sel].max()):.3f}] W/m^2, water flux "
            f"max|.| {float(oforc.water_flux[sel].abs().max()):.3e} m/s; "
            f"top-row T in [{float(T_top[sel].min()):.4f}, "
            f"{float(T_top[sel].max()):.4f}] C")
    say(f"phase 16 under the shelf: max a_ice, m_ice {ice_under:.3e}; "
        f"max|melt heat flux| over the 10 steps {melt:.3f} W/m^2; values "
        f"not 0 above the tops {nonzero_above}")
    if ice_under != 0.0:
        fail("phase 16: sea ice under the shelf")
    if not melt > 0.0:
        fail("phase 16: no melt heat flux under the shelf")
    if any(nonzero_above.values()):
        fail(f"phase 16: values above the cavities' tops {nonzero_above}")
    sruns = {}
    for dtype, m in sm.items():
        s_, i_ = pi_initial_state(m)
        s_, i_ = run_pi(m, satm[dtype], s_, i_, 2)
        sruns[dtype] = [m, s_, i_, 2]
    for dtype in (torch.float32, torch.float64):
        mdl, s_, i_, k0 = sruns[dtype]
        n = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_, i_ = run_pi(mdl, satm[dtype], s_, i_, n, first_step=k0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sruns[dtype][1:] = [s_, i_, k0 + n]
        if not (torch.isfinite(s_.eta).all()
                and torch.isfinite(i_.u_ice).all()):
            fail("phase 16: eta or u_ice is not finite")
        say(f"phase 16 throughput {str(dtype).replace('torch.', '')}: "
            f"{n / wall:.3f} coupled steps/s, {swet * n / wall:.6e} wet "
            f"node-levels/s ({swet} wet node-levels; {card})")
    shelf_us, shelf_launches_dtype = {}, {}
    for dtype, (mdl, s_, i_, k0) in sruns.items():
        tag = str(dtype).replace("torch.", "")
        kernels.reset_launches()
        shelf_us[tag] = profile_steps(
            "phase 16", mdl, s_, 3, card,
            run=lambda m, st_, k, a=satm[dtype], i=i_, k0=k0:
            run_pi(m, a, st_, i, k, first_step=k0),
            also=("elem_to_node_mean", "fct_bounds", "pressure_bv",
                  "kpp_column"),
            spans=span_ms["shelf"].setdefault(tag, {}))
        shelf_launches_dtype[tag] = {k: kernels.LAUNCHES[k] / 3
                                     for k in coupled_kernels}
        idle = [k for k in coupled_kernels
                if shelf_launches_dtype[tag][k] <= 0]
        if idle:
            fail(f"phase 16 {tag}: kernels of the path never launched {idle}")
        if "step.cavity" not in span_ms["shelf"][tag]:
            say(f"phase 16 {tag}: the step.cavity span holds no kernel in "
                f"the profile")
    shelf_ms = {tag: {k: sum(v for key, v in us.items()
                             if any(f in key for f in functions[k])) / 1e3
                      or None for k in coupled_kernels}
                for tag, us in shelf_us.items()}
    say(f"phase 16 device ms a coupled step per kernel (profile): {shelf_ms}")

    # phase 17 -----------------------------------------------------------
    phase_start(17, t_start)
    # card against CPU, 3 float64 coupled steps each: the shelf on the
    # level-3 globe (CI dense and CG forced; the fast configuration with
    # cavity partial cells under each PGF form it takes), and the CI step
    # on the level-2 globe refined once
    draft3 = globe.shelf_draft(read_raw_mesh(small))
    l2 = globe.write_globe(str(Path(__file__).resolve().parent / "build"
                               / "chip_smoke" / "globe_l2"), level=2)

    def cavity_cfg(parity, **run):
        cfg = port_model.pi_config(parity)
        for k, v in run.items():
            setattr(cfg.run, k, v)
        return cfg

    cases17 = [("CI coupled, shelf, dense", small, dense_max_saved,
                lambda: port_model.pi_config(), dict(cavity_depth=draft3)),
               ("CI coupled, shelf, CG forced", small, 0,
                lambda: port_model.pi_config(), dict(cavity_depth=draft3))]
    for w in ("sergey", "shchepetkin", "easypgf"):
        def fast_cfg(w=w):
            cfg = cavity_cfg("fast", use_cavity_partial_cell=True)
            cfg.dyn.which_pgf = w
            return cfg
        cases17.append((f"fast coupled, shelf, cavity partial cells, "
                        f"which_pgf={w}", small, dense_max_saved, fast_cfg,
                        dict(cavity_depth=draft3)))
    cases17.append(("CI coupled, level-2 globe, n_refine=1", l2,
                    dense_max_saved, lambda: port_model.pi_config(),
                    dict(n_refine=1)))
    t17 = time.perf_counter()
    for label, where, limit, make_cfg, kw in cases17:
        port_model.DENSE_SSH_MAX_NODES = limit
        try:
            on_gpu, atm_gpu = setup_pi_model(where, device=dev,
                                             cfg=make_cfg(), **kw)
            on_cpu, atm_cpu = setup_pi_model(where, device="cpu",
                                             cfg=make_cfg(), **kw)
        finally:
            port_model.DENSE_SSH_MAX_NODES = dense_max_saved
        kernels.reset_launches()
        s_gpu, i_gpu = run_pi(on_gpu, atm_gpu, *pi_initial_state(on_gpu), 3)
        n_card = sum(kernels.LAUNCHES.values())
        s_cpu, i_cpu = run_pi(on_cpu, atm_cpu, *pi_initial_state(on_cpu), 3)
        if n_card <= 0 or sum(kernels.LAUNCHES.values()) != n_card:
            fail(f"phase 17: {label}: the card's path launched no kernel, or "
                 f"the CPU path launched one")
        mesh_c = on_cpu.mesh
        # Kv on the interfaces each column has: above a cavity's top KPP
        # fills rows nothing reads
        kv = lambda s_, m_: torch.where(m_.node_level_mask, s_.Kv, 0.0)
        worst = 0.0
        for obj_gpu, obj_cpu, names in (
                (s_gpu, s_cpu, ("u", "v", "eta", "hbar", "tr", "w", "hnode",
                                "pgf_x", "Kv")),
                (i_gpu, i_cpu, ("u_ice", "v_ice", "m_ice", "a_ice",
                                "sigma11"))):
            for name in names:
                if name == "Kv":
                    got, ref = kv(s_gpu, on_gpu.mesh).cpu(), kv(s_cpu, mesh_c)
                else:
                    got, ref = getattr(obj_gpu, name).cpu(), getattr(obj_cpu,
                                                                     name)
                rel = max_abs(got, ref) / max(float(ref.abs().max()), 1e-300)
                if not rel <= 1e-8:
                    fail(f"phase 17: {label} {name} card vs CPU {rel:.3e} "
                         f"> 1e-8")
                worst = max(worst, rel)
        menu_report[label] = worst
        say(f"phase 17 {label} ({mesh_c.n_nodes} nodes, "
            f"{int((mesh_c.ulevels_node > 1).sum())} cavity nodes, use_cavity"
            f" {on_cpu.cfg.run.use_cavity}): worst field card vs cpu "
            f"{worst:.3e} of max|cpu|; {n_card} kernel launches on the card; "
            f"CG iterations of the 3rd step {on_gpu.ssh_iters}")
    say(f"phase 17 {len(cases17)} cases in {time.perf_counter() - t17:.1f} s")

    # phase 18 -----------------------------------------------------------
    phase_start(18, t_start)
    # the level-6 globe refined once (setup_pi_model(n_refine=1)): about
    # the level-7 globe's size, numbered as the subdivision leaves it
    l6 = globe.write_globe(str(Path(__file__).resolve().parent / "build"
                               / "chip_smoke" / "globe_l6"), level=6)
    rm, ratm, rm_setup = {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rm[dtype], ratm[dtype] = setup_pi_model(l6, device=dev, dtype=dtype,
                                                n_refine=1)
        torch.cuda.synchronize()
        rm_setup[dtype] = time.perf_counter() - t0
    rmesh = rm[torch.float64].mesh
    rwet = int(rmesh.node_layer_mask.sum())
    say(f"phase 18 refined level-6 globe: {read_raw_mesh(l6).n_nodes} nodes "
        f"refined to N={rmesh.n_nodes} E={rmesh.n_elems} Ed={rmesh.n_edges} "
        f"layers={rmesh.nl - 1}, {rwet} wet node-levels (the level-7 globe: "
        f"N={gmesh.n_nodes}); setup float64 {rm_setup[torch.float64]:.3f} s, "
        f"float32 {rm_setup[torch.float32]:.3f} s")
    rm64 = rm[torch.float64]
    stepr = pi_coupled_step_fn(rm64, ratm[torch.float64])
    st, ice = pi_initial_state(rm64)
    ice0 = ice
    area = rmesh.area[0]
    kernels.reset_launches()
    iters, hbar_expected = [], 0.0
    for k in range(5):
        st, ice, oforc = stepr(st, ice, k)
        iters.append(rm64.ssh_iters)
        hbar_expected = hbar_expected - rm64.cfg.dt * (
            oforc.water_flux * area).sum() / area.sum()
    torch.cuda.synchronize()
    refined_launches = {k: kernels.LAUNCHES[k] for k in coupled_kernels}
    say(f"phase 18 refined coupled CI step, 5 steps float64: CG iterations "
        f"per step {iters}, launches per step "
        f"{ {k: v / 5 for k, v in refined_launches.items()} }")
    check_globe("phase 18", rm64, st, refined_launches, float(hbar_expected))
    check_ice("phase 18", rm64, st, ice, ice0, n_steps=5)
    refined_rate = {}
    for dtype in (torch.float32, torch.float64):
        m = rm[dtype]
        s_, i_ = run_pi(m, ratm[dtype], *pi_initial_state(m), 2)
        n = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_, i_ = run_pi(m, ratm[dtype], s_, i_, n, first_step=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not (torch.isfinite(s_.eta).all()
                and torch.isfinite(i_.u_ice).all()):
            fail("phase 18: eta or u_ice is not finite")
        tag = str(dtype).replace("torch.", "")
        refined_rate[tag] = n / wall
        say(f"phase 18 throughput {tag}: {n / wall:.3f} coupled steps/s, "
            f"{rwet * n / wall:.6e} wet node-levels/s ({rwet} wet "
            f"node-levels; {m.ssh_iters} CG iterations in the last step; "
            f"{card})")
    # the gather kernels on the subdivision's numbering, beside phase 3's
    # times on both numberings of the level-7 globe
    refined_us = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        mesh = rm[dtype].mesh
        L_, N_, E_, Ed_ = (mesh.nl - 1, mesh.n_nodes, mesh.n_elems,
                           mesh.n_edges)
        f = rand(2, L_, Ed_, dtype=dtype)
        x = rand(2, L_, E_, dtype=dtype)
        ttf = rand(2, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
        lo_ = rand(2, L_, N_, lo=0.0, hi=30.0, dtype=dtype)
        for name, kern in (
                ("node_edge_reduce div", lambda: ops.edge_divergence(f, mesh)),
                ("elem_to_node_mean", lambda: ops.elem_to_node_mean(x, mesh)),
                ("fct_bounds", lambda: tracers.fct_bounds(ttf, lo_, mesh))):
            us, batch = device_us(kern), timed_batch(kern, 20) * 1e3
            refined_us.setdefault(name, {})[tag] = {"device_us": us,
                                                    "batch_us": batch}
            level7 = numbering_us.get(name, {}).get(tag, {})
            say(f"phase 18 {name:22s} {tag} refined level-6: device_us="
                f"{us_text(us)}, us a call of 20 between two events="
                f"{batch:.2f}; level-7 globe (phase 3, the same) along the "
                f"curve {level7.get('curve', {}).get('device_us')} / "
                f"{level7.get('curve', {}).get('batch_us')}, by subdivision "
                f"{level7.get('subdivision', {}).get('device_us')} / "
                f"{level7.get('subdivision', {}).get('batch_us')} ({card})")

    # phase 19 -----------------------------------------------------------
    phase_start(19, t_start)
    # the column-physics menus on the CI coupled step at full width: the
    # TKE closure with IDEMIX, the salt plume and six tracers (T, S, the
    # rain tracer 101, the strait tracers 301-303) on the level-7 globe,
    # with phase 12's tables (the models share phase 3's buffers: nothing
    # of the setup depends on these knobs) and atmosphere
    from fesom2_tpu_torch.model import Model

    def tke_model(m):
        cfg = copy.deepcopy(m.cfg)
        cfg.dyn.mix_scheme = "cvmix_TKE+cvmix_IDEMIX"
        cfg.dyn.SPP = True
        cfg.tra.num_tracers = 6
        cfg.tra.tracer_ID = [0, 1, 101, 301, 302, 303]
        return Model(m.mesh, cfg, m.tracer_statics, m.density_ref,
                     ice_sub=m.ice_sub, ssh_dense_inv=m.ssh_dense_inv,
                     ssh_ring=m.ssh_ring, ssh_block_pc=m.ssh_block_pc)

    tm = {dtype: tke_model(m) for dtype, m in gm.items()}
    tm64 = tm[torch.float64]
    region_nodes = {tid: int(mask.sum()) for tid, mask in zip(
        (301, 302, 303), tm64.ptr_masks)}
    say(f"phase 19 strait regions on the level-7 globe, nodes: "
        f"{region_nodes}")
    tke_kernels = tuple(k for k in coupled_kernels if k != "kpp_column")
    nmask = gmesh.node_layer_mask
    lev = torch.arange(gmesh.nl, device=dev)[:, None]
    active = lev <= (gmesh.nlevels_node - 1)[None, :]

    def tke_run(redi: bool, n: int = 10):
        """n float64 coupled steps from the initial state: the state, the
        ice, the last forcing, the launches, hbar's expected mean, the
        largest prec_rain and the rain inventory after each step."""
        tm64.cfg.dyn.Redi = redi
        step = pi_coupled_step_fn(tm64, gatm[torch.float64])
        st_, ice_ = pi_initial_state(tm64)
        kernels.reset_launches()
        hbar_exp, rain, inv = 0.0, 0.0, []
        vol = tm64.mesh.areasvol[:-1]
        for k in range(n):
            st_, ice_, of_ = step(st_, ice_, k)
            hbar_exp = hbar_exp - tm64.cfg.dt * (
                of_.water_flux * area).sum() / area.sum()
            rain = max(rain, float(of_.prec_rain.max()))
            inv.append(float((st_.tr[2] * st_.hnode * vol)[nmask].sum()))
        torch.cuda.synchronize()
        launch = {k: kernels.LAUNCHES[k] for k in coupled_kernels}
        tm64.cfg.dyn.Redi = True
        return st_, ice_, of_, launch, float(hbar_exp), rain, inv

    area = gmesh.area[0]
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, ice, oforc, tke_launches, hbar_expected, rain, rain_inv = \
        tke_run(True)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_tke_step = {k: v / 10 for k, v in tke_launches.items()}
    say(f"phase 19 TKE+IDEMIX coupled CI step with SPP and six tracers, 10 "
        f"steps float64: {wall:.3f} s, launches per step {per_tke_step}; "
        f"peak memory allocated {peak_gb:.2f} GiB, {peak_gb - base_gb:.2f} "
        f"GiB above the {base_gb:.2f} GiB the earlier phases' models hold "
        f"({card})")
    check_globe("phase 19", tm64, st, {k: tke_launches[k]
                                       for k in tke_kernels}, hbar_expected)
    check_ice("phase 19", tm64, st, ice, pi_initial_state(tm64)[1],
              n_steps=10)
    if tke_launches["kpp_column"] != 0:
        fail(f"phase 19: kpp_column launched {tke_launches['kpp_column']} "
             f"times under cvmix_TKE")
    tke_calls = {"pressure_bv": 1, "tridiag_solve": 6,
                 "elem_contrib_to_nodes": 6, "mevp_subcycles": 1}
    for k, want in tke_calls.items():
        if per_tke_step[k] != want:
            fail(f"phase 19: {k} launched {per_tke_step[k]} times a step, "
                 f"not {want}")
    tke_ok = bool(torch.isfinite(st.tke).all()) \
        and float(st.tke[active].min()) >= 0.0
    iwe_ok = bool(torch.isfinite(st.iwe).all()) and float(st.iwe.min()) >= 0.0
    kv_ok = all(bool(torch.isfinite(f).all()) and float(f.min()) >= 0.0
                for f in (st.Kv, st.Av))
    say(f"phase 19 tke in [{float(st.tke[active].min()):.3e}, "
        f"{float(st.tke.max()):.3e}], iwe in [{float(st.iwe.min()):.3e}, "
        f"{float(st.iwe.max()):.3e}] (IDEMIX forcing is zero, as in the JAX "
        f"package), Kv in [{float(st.Kv.min()):.3e}, {float(st.Kv.max()):.3e}]"
        f", Av in [{float(st.Av.min()):.3e}, {float(st.Av.max()):.3e}]")
    if not (tke_ok and iwe_ok and kv_ok):
        fail("phase 19: tke, iwe, Kv or Av not finite or negative")

    def tracer_report(label, st_):
        out = {}
        for i, tid in enumerate((101, 301, 302, 303), start=2):
            t = st_.tr[i][nmask]
            out[tid] = (float(t.min()), float(t.max()))
        say(f"phase 19 {label}: passive tracers (min, max) {out}")
        return out

    def region_held(label, st_):
        for (i, mask), tid in zip(tm64.ptracer_masks(), (301, 302, 303)):
            if region_nodes[tid] == 0:
                continue
            held = st_.tr[i][mask[None, :] & nmask]
            if not bool((held == 1.0).all()):
                fail(f"phase 19 {label}: tracer {tid} not held at 1 in its "
                     f"region ({float((held - 1).abs().max()):.3e})")

    bounds = tracer_report("CI (with Redi)", st)
    region_held("CI", st)
    say(f"phase 19 rain tracer inventory (sum of tr_101 h areasvol) after "
        f"each step: {rain_inv}; largest prec_rain {rain:.3e} m/s")
    if rain > 0.0 and not (rain_inv[-1] > 0.0
                           and all(b > a for a, b in zip(rain_inv,
                                                         rain_inv[1:]))):
        fail("phase 19: the rain-water inventory does not grow under "
             "positive prec_rain")
    if not all(np.isfinite(v).all() for v in bounds.values()):
        fail("phase 19: a passive tracer is not finite")
    # the explicit Redi fluxes are not limited (the JAX package's are not
    # either): the passive tracers' bounds (101 >= 0, 301-303 in [0, 1])
    # are a property of the advection (FCT) and the implicit vertical
    # diffusion, gated on the same 10 steps with the Redi terms off
    st_nr, _, _, nr_launches, _, _, _ = tke_run(False)
    nr_bounds = tracer_report("without Redi", st_nr)
    region_held("without Redi", st_nr)
    for tid in (301, 302, 303):
        lo_, hi_ = nr_bounds[tid]
        if not (lo_ >= -1e-9 and hi_ <= 1.0 + 1e-9):
            fail(f"phase 19: tracer {tid} outside [-1e-9, 1 + 1e-9] without "
                 f"the Redi terms: [{lo_:.3e}, {hi_:.3e}]")
    if nr_bounds[101][0] < -1e-9 or nr_launches["kpp_column"]:
        fail("phase 19: tracer 101 below -1e-9 or kpp_column launched, "
             "without Redi")
    # throughput in both dtypes, 10 steps each after 2
    truns, tke_rate = {}, {}
    for dtype, m in tm.items():
        s_, i_ = pi_initial_state(m)
        s_, i_ = run_pi(m, gatm[dtype], s_, i_, 2)
        truns[dtype] = [m, s_, i_, 2]
    for dtype in (torch.float32, torch.float64):
        mdl, s_, i_, k0 = truns[dtype]
        n = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_, i_ = run_pi(mdl, gatm[dtype], s_, i_, n, first_step=k0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        truns[dtype][1:] = [s_, i_, k0 + n]
        if not (torch.isfinite(s_.eta).all()
                and torch.isfinite(i_.u_ice).all()):
            fail("phase 19: eta or u_ice is not finite")
        tag = str(dtype).replace("torch.", "")
        tke_rate[tag] = n / wall
        say(f"phase 19 throughput {tag}: {n / wall:.3f} coupled steps/s, "
            f"{wet * n / wall:.6e} wet node-levels/s ({wet} wet "
            f"node-levels; {card})")
    span_ms["tke"] = {}
    tke_us, tke_launches_dtype, tke_host, tke_counts = {}, {}, {}, {}
    for dtype, (mdl, s_, i_, k0) in truns.items():
        tag = str(dtype).replace("torch.", "")
        kernels.reset_launches()
        tke_us[tag] = profile_steps(
            "phase 19", mdl, s_, 3, card,
            run=lambda m, st_, k, a=gatm[dtype], i=i_, k0=k0:
            run_pi(m, a, st_, i, k, first_step=k0),
            also=("tridiag_solve", "fct_bounds"),
            spans=span_ms["tke"].setdefault(tag, {}),
            host_spans=tke_host.setdefault(tag, {}),
            span_counts=tke_counts.setdefault(tag, {}))
        tke_launches_dtype[tag] = {k: kernels.LAUNCHES[k] / 3
                                   for k in coupled_kernels}
        idle = [k for k in tke_kernels if tke_launches_dtype[tag][k] <= 0]
        if idle or tke_launches_dtype[tag]["kpp_column"]:
            fail(f"phase 19 {tag}: kernels of the path never launched {idle}"
                 f", or kpp_column launched")
        mix = {k: (span_ms["tke"][tag].get(k, 0.0), tke_host[tag].get(k),
                   tke_counts[tag].get(k, 0))
               for k in ("step.mixing.tke", "step.mixing.idemix",
                         "step.mixing")}
        dev_all = sum(v[0] for v in mix.values())
        host_all = sum(v[1] or 0.0 for v in mix.values())
        say(f"phase 19 mixing {tag} a step (device ms, host ms, kernels) per "
            f"span: {mix}; TKE+IDEMIX share of the mixing: device "
            f"{(mix['step.mixing.tke'][0] + mix['step.mixing.idemix'][0]) / max(dev_all, 1e-12):.3f}"
            f", host {((mix['step.mixing.tke'][1] or 0) + (mix['step.mixing.idemix'][1] or 0)) / max(host_all, 1e-12):.3f} "
            f"({card})")
    tke_ms = {tag: {k: sum(v for key, v in us.items()
                           if any(f in key for f in functions[k])) / 1e3
                    or None for k in coupled_kernels}
              for tag, us in tke_us.items()}
    say(f"phase 19 device ms a coupled step per kernel (profile): {tke_ms}")

    # phase 20 -----------------------------------------------------------
    phase_start(20, t_start)
    # the menus of this slice, card against CPU on the level-3 globe, 3
    # float64 steps each (the ocean alone unless the case needs the ice),
    # and the toy channel cases on the soufflet channel

    def slice_cfg(ocean_only, **knobs):
        cfg = port_model.pi_config()
        cfg.run.use_ice = not ocean_only
        for k, v in knobs.items():
            sec = "dyn" if hasattr(cfg.dyn, k) else "tra"
            setattr(getattr(cfg, sec), k, v)
        return cfg

    cases20 = [(f"tra_adv_hor={h}", slice_cfg(True, tra_adv_hor=h))
               for h in ("UPW1", "MUSCL", "MFCT")]
    cases20 += [(f"tra_adv_ver={v}", slice_cfg(True, tra_adv_ver=v))
                for v in ("UPW1", "CDIFF", "PPM")]
    cases20 += [("tra_adv_lim=NONE, w split",
                 slice_cfg(True, tra_adv_lim="NONE", w_max_cfl=1e-5)),
                ("tra_adv_lim=NONE, no w split",
                 slice_cfg(True, tra_adv_lim="NONE", w_split=False)),
                ("i_vert_visc=False", slice_cfg(True, i_vert_visc=False)),
                ("i_vert_diff=False", slice_cfg(True, i_vert_diff=False))]
    cases20 += [(f"mix_scheme={ms}", slice_cfg(True, mix_scheme=ms))
                for ms in ("cvmix_PP", "cvmix_TKE", "cvmix_IDEMIX",
                           "cvmix_KPP", "KPP+cvmix_TIDAL",
                           "PP+cvmix_DDIFF+cvmix_CONV")]
    cases20 += [("mix_scheme=cvmix_TKE+cvmix_IDEMIX, SPP, six tracers "
                 "(coupled)",
                 slice_cfg(False, mix_scheme="cvmix_TKE+cvmix_IDEMIX",
                           SPP=True, num_tracers=6,
                           tracer_ID=[0, 1, 101, 301, 302, 303])),
                ("toy channel 'channel' (soufflet channel, no soufflet "
                 "physics)", "toy"),
                ("sea ice on the toy channel (coupled_step_fn)", "toy_ice")]
    slice_report = {}
    t20 = time.perf_counter()
    for label, cfg in cases20:
        kernels.reset_launches()
        outs = []
        for i, d in enumerate((dev, "cpu")):
            if cfg in ("toy", "toy_ice"):
                scfg = port_model.soufflet_config(which_ale="zstar")
                scfg.run.which_toy = "channel"
                if cfg == "toy_ice":
                    scfg.run.which_toy = "soufflet"
                    scfg.run.use_ice = True
                    scfg.ice.whichEVP = 1
                    scfg.ice.evp_rheol_steps = 8
                m = setup_soufflet_model(device=d, cfg=scfg)
                if cfg == "toy":
                    _, s_, _ = run_soufflet(3, model=m, verbose=False)
                    outs.append((s_, None))
                else:
                    N_, mesh_ = m.mesh.n_nodes, m.mesh
                    full = lambda v: torch.full((N_,), v, device=d,
                                                dtype=torch.float64)
                    ice_ = allocate_ice(mesh_, torch.float64)
                    ice_ = dataclasses.replace(ice_, a_ice=full(0.8),
                                               m_ice=full(1.5),
                                               m_snow=full(0.2))
                    ifc = dataclasses.replace(
                        zero_ice_forcing(mesh_), Tair=full(-5.0),
                        shortwave=full(100.0), longwave=full(250.0),
                        shum=full(2e-3), u_wind=full(8.0),
                        stress_atmice_x=full(0.1),
                        stress_atmoce_x=full(0.1))
                    of_ = dataclasses.replace(
                        zero_forcing(mesh_), stress_x=torch.full(
                            (mesh_.n_elems,), 0.1, device=d,
                            dtype=torch.float64))
                    cstep = coupled_step_fn(m)
                    s_ = m.initial_state()
                    for _ in range(3):
                        s_, ice_, _ = cstep(s_, ice_, of_, ifc)
                    outs.append((s_, ice_))
            elif cfg.run.use_ice:
                m, atm = setup_pi_model(small, device=d, cfg=cfg)
                outs.append(run_pi(m, atm, *pi_initial_state(m), 3))
            else:
                m, _ = setup_pi_model(small, device=d, cfg=cfg)
                outs.append((run_pi_ocean(m, *globe_ocean_inputs(m), 3),
                             None))
            if i == 0:
                n_card = sum(kernels.LAUNCHES.values())
        if n_card <= 0 or sum(kernels.LAUNCHES.values()) != n_card:
            fail(f"phase 20: {label}: the card's path launched no kernel, or "
                 f"the CPU path launched one")
        (s_gpu, i_gpu), (s_cpu, i_cpu) = outs
        names = ["u", "v", "eta", "hbar", "tr", "w", "hnode", "Kv", "Av",
                 "Kv_s", "tke", "iwe", "kpp_nonloc"]
        checks = [(s_gpu, s_cpu, names)]
        if i_cpu is not None:
            checks.append((i_gpu, i_cpu, ("u_ice", "v_ice", "m_ice", "a_ice",
                                          "sigma11")))
        worst = 0.0
        for obj_gpu, obj_cpu, fields in checks:
            for name in fields:
                ref = getattr(obj_cpu, name)
                rel = max_abs(getattr(obj_gpu, name).cpu(), ref) \
                    / max(float(ref.abs().max()), 1e-300)
                if not rel <= 1e-8:
                    fail(f"phase 20: {label} {name} card vs CPU {rel:.3e} "
                         f"> 1e-8")
                worst = max(worst, rel)
        slice_report[label] = worst
        say(f"phase 20 {label}: worst field card vs cpu {worst:.3e} of "
            f"max|cpu| over {names}{' and the ice' if i_cpu is not None else ''}"
            f"; {n_card} kernel launches on the card")
    say(f"phase 20 {len(cases20)} cases in {time.perf_counter() - t20:.1f} s")

    # phase 21 -----------------------------------------------------------
    phase_start(21, t_start)
    # standard (whichEVP=0) and adaptive (2) EVP on the CI coupled step at
    # full width: phase 12's tables (shared buffers) and atmosphere, the
    # subdomain poleward of 40 degrees, the rheology's instantiation of
    # the subcycle kernel once a step and mevp_subcycles never

    def rheology_model(m, which):
        cfg = copy.deepcopy(m.cfg)
        cfg.ice.whichEVP = which
        return Model(m.mesh, cfg, m.tracer_statics, m.density_ref,
                     ice_sub=m.ice_sub, ssh_dense_inv=m.ssh_dense_inv,
                     ssh_ring=m.ssh_ring, ssh_block_pc=m.ssh_block_pc)

    area = gmesh.area[0]
    rheo_report = {}
    for which, kname in ((0, "evp_subcycles"), (2, "aevp_subcycles")):
        label = f"phase 21 whichEVP={which}"
        rm = {dtype: rheology_model(m, which) for dtype, m in gm.items()}
        rm64 = rm[torch.float64]
        step21 = pi_coupled_step_fn(rm64, gatm[torch.float64])
        st, ice = pi_initial_state(rm64)
        ice0 = ice
        kernels.reset_launches()
        hbar_expected = 0.0
        t0 = time.perf_counter()
        for k in range(10):
            st, ice, oforc = step21(st, ice, k)
            hbar_expected = hbar_expected - rm64.cfg.dt * (
                oforc.water_flux * area).sum() / area.sum()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launch = {k: kernels.LAUNCHES[k] for k in coupled_kernels + (kname,)}
        say(f"{label} 10 steps float64 on the level-7 globe: {wall:.3f} s, "
            f"launches {launch}")
        check_globe(label, rm64, st, {k: launch[k] for k in launch
                                      if k != "mevp_subcycles"},
                    float(hbar_expected))
        check_ice(label, rm64, st, ice, ice0, n_steps=10)
        if launch[kname] != 10 or launch["mevp_subcycles"] != 0:
            fail(f"{label}: {kname} launched {launch[kname]} times in 10 "
                 f"steps, mevp_subcycles {launch['mevp_subcycles']}")
        path_launches[kname] = launch[kname]
        rep = {}
        if which == 2:
            al, be = ice.alpha_aevp, ice.beta_aevp
            rep["alpha"] = [float(al.min()), float(al.max())]
            rep["beta"] = [float(be.min()), float(be.max())]
            rep["alpha_elements_moved"] = int((al != ice0.alpha_aevp).sum())
            say(f"{label} alpha_aevp in {rep['alpha']} ("
                f"{rep['alpha_elements_moved']} elements refreshed), "
                f"beta_aevp in {rep['beta']}")
            if not (bool(torch.isfinite(al).all())
                    and bool(torch.isfinite(be).all())
                    and min(rep["alpha"][0], rep["beta"][0]) >= 50.0):
                fail(f"{label}: alpha_aevp or beta_aevp not finite or under "
                     f"50")
        # coupled steps a second in both dtypes, 10 steps each after 2
        runs, rates = {}, {}
        for dtype, m in rm.items():
            s_, i_ = pi_initial_state(m)
            s_, i_ = run_pi(m, gatm[dtype], s_, i_, 2)
            runs[dtype] = [m, s_, i_, 2]
        for dtype in (torch.float32, torch.float64):
            mdl, s_, i_, k0 = runs[dtype]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_, i_ = run_pi(mdl, gatm[dtype], s_, i_, 10, first_step=k0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[dtype][1:] = [s_, i_, k0 + 10]
            if not (torch.isfinite(s_.eta).all()
                    and torch.isfinite(i_.u_ice).all()):
                fail(f"{label}: eta or u_ice is not finite")
            tag = str(dtype).replace("torch.", "")
            rates[tag] = 10 / wall
            say(f"{label} throughput {tag}: {10 / wall:.3f} coupled steps/s, "
                f"{wet * 10 / wall:.6e} wet node-levels/s ({card})")
        # a 3-step profile per dtype: step.ice.evp's device and host ms
        evp_span = {}
        for dtype, (mdl, s_, i_, k0) in runs.items():
            tag = str(dtype).replace("torch.", "")
            dev_sp, host_sp, cnt_sp = {}, {}, {}
            kernels.reset_launches()
            profile_steps(label, mdl, s_, 3, card,
                          run=lambda m, st_, k, a=gatm[dtype], i=i_, k0=k0:
                          run_pi(m, a, st_, i, k, first_step=k0),
                          also=("subcycles",), spans=dev_sp,
                          host_spans=host_sp, span_counts=cnt_sp)
            if kernels.LAUNCHES[kname] != 3 \
                    or kernels.LAUNCHES["mevp_subcycles"]:
                fail(f"{label} {tag}: {kname} not once a profiled step, or "
                     f"mevp_subcycles launched")
            evp_span[tag] = {"device_ms": dev_sp.get("step.ice.evp"),
                             "host_ms": host_sp.get("step.ice.evp"),
                             "kernels": cnt_sp.get("step.ice.evp")}
            span_ms.setdefault(f"whichEVP={which}", {})[tag] = dev_sp
            say(f"{label} step.ice.evp {tag} a step: device "
                f"{us_text(evp_span[tag]['device_ms'])} ms, host "
                f"{us_text(evp_span[tag]['host_ms'])} ms, "
                f"{evp_span[tag]['kernels']} kernels ({card})")
        rep.update(coupled_steps_per_s=rates, step_ice_evp=evp_span)
        rheo_report[f"whichEVP={which}"] = rep

    # phase 22 -----------------------------------------------------------
    phase_start(22, t_start)
    # forcing and initial state from files at full width: the NCEP
    # test-set layout on the T62 grid's shape (192 x 94, latitudes
    # descending, 8 six-hourly wind records, 2 of radiation and of
    # precipitation, CF units) and a WOA18-style climatology (72 x 36
    # columns down to 7,000 m, missing values), written from a seed; the
    # tidal potential and the sea-level pressure term on, the relaxation
    # to climatology in a sponge poleward of 60 degrees
    from fesom2_tpu_torch.forcing import synthetic
    from fesom2_tpu_torch.forcing.atmos import load_sbc_forcing
    fdir = str(Path(__file__).resolve().parent / "build" / "chip_smoke"
               / "forcing")
    t0 = time.perf_counter()
    synthetic.write_ncep_test_set(fdir, seed=22)
    synthetic.write_woa18(fdir, seed=22)
    t_write = time.perf_counter() - t0
    cfg22 = port_model.pi_config()
    cfg22.run.use_global_tides = True
    cfg22.run.l_mslp = True
    cfg22.tra.clim_relax = 1.0 / (30.0 * 86400.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm, fatm = setup_pi_model(globe_path, device=dev, cfg=cfg22,
                              forcing_path=fdir)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    st, ice = pi_initial_state(fm, forcing_path=fdir)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    # the loading: the initial state (the WOA climatology to the nodes)
    # and the forcing files (read, interpolated and copied to the card),
    # timed once more alone; building: the rest of setup_pi_model
    t0 = time.perf_counter()
    load_sbc_forcing(fm.mesh, fm.sbc, year=1948)
    torch.cuda.synchronize()
    t_forcing = time.perf_counter() - t0
    t_load = (t_setup - t_model) + t_forcing
    glat = fm.mesh.geo_coords[:, 1].abs()
    fm.relax2clim = torch.where(glat > np.radians(60.0),
                                torch.full_like(glat, cfg22.tra.clim_relax),
                                torch.zeros_like(glat))
    setup22 = {"total_s": t_setup, "loading_s": t_load,
               "building_s": t_setup - t_load, "forcing_files_s": t_forcing,
               "climatology_s": t_setup - t_model,
               "writing_files_s": t_write}
    say(f"phase 22 setup from files {t_setup:.3f} s: loading {t_load:.3f} "
        f"s (the forcing files, read, interpolated and copied to the card, "
        f"{t_forcing:.3f} s; the WOA climatology to the nodes, "
        f"{t_setup - t_model:.3f} s), building (mesh tables, statics, SSH "
        f"solver, subdomain) {t_setup - t_load:.3f} s; the "
        f"files written in {t_write:.3f} s; forcing records "
        f"{list(fatm.u_wind.shape)}, {list(fatm.swdn.shape)}, "
        f"{list(fatm.prec.shape)}; sbc y_perpetual {fm.sbc.y_perpetual}; "
        f"sponge nodes {int((fm.relax2clim > 0).sum())}; nodes with ice "
        f"{int((ice.a_ice > 0).sum())} ({card})")
    step22 = pi_coupled_step_fn(fm, fatm)
    ice0 = ice
    kernels.reset_launches()
    hbar_expected = 0.0
    t0 = time.perf_counter()
    for k in range(10):
        st, ice, oforc = step22(st, ice, k)
        hbar_expected = hbar_expected - fm.cfg.dt * (
            oforc.water_flux * area).sum() / area.sum()
    torch.cuda.synchronize()
    wall22 = time.perf_counter() - t0
    launch = {k: kernels.LAUNCHES[k] for k in coupled_kernels}
    say(f"phase 22 10 steps float64 from files: {wall22:.3f} s, "
        f"{10 / wall22:.3f} coupled steps/s, launches {launch}")
    check_globe("phase 22", fm, st, launch, float(hbar_expected))
    check_ice("phase 22", fm, st, ice, ice0, n_steps=10)
    gp = oforc.ssh_gp
    say(f"phase 22 ssh_gp in [{float(gp.min()):.4f}, {float(gp.max()):.4f}] "
        f"m^2/s^2, press_air max|{float(oforc.press_air.abs().max()):.1f}| "
        f"(not carried, as in the JAX package); T in the sponge against "
        f"Tclim: max|T - Tclim| "
        f"{float(((st.tr[0] - fm.Tclim) * (fm.relax2clim > 0)).abs().max()):.4f}")
    if not (bool(torch.isfinite(gp).all()) and float(gp.abs().max()) > 0.0):
        fail("phase 22: ssh_gp is zero or not finite")
    span22, host22, cnt22 = {}, {}, {}
    profile_steps("phase 22", fm, st, 3, card,
                  run=lambda m, st_, k, i=ice: run_pi(m, fatm, st_, i, k,
                                                      first_step=10),
                  spans=span22, host_spans=host22, span_counts=cnt22)
    span_ms["files"] = {"float64": span22}
    files_report = {"setup": setup22, "coupled_steps_per_s_float64":
                    10 / wall22,
                    "step.forcing": {"device_ms": span22.get("step.forcing"),
                                     "host_ms": host22.get("step.forcing")}}

    # phase 23 -----------------------------------------------------------
    phase_start(23, t_start)
    # card against CPU on the level-3 globe, 3 float64 coupled steps each:
    # every field within 1e-8 of max|CPU|, no kernel launched on the CPU
    from fesom2_tpu_torch.ice.coupling import ocean2ice as o2i
    from fesom2_tpu_torch.ice.step import ice_timestep_cpl
    from fesom2_tpu_torch.ice.thermo_cpl import CoupledAtmFluxes

    def cfg23(**knobs):
        cfg = port_model.pi_config()
        for k, v in knobs.items():
            sec = next(s for s in ("ice", "run", "tra") if hasattr(
                getattr(cfg, s), k))
            setattr(getattr(cfg, sec), k, v)
        return cfg

    cases23 = []
    for which in (0, 2):
        cases23 += [(f"whichEVP={which} subdomain", cfg23(whichEVP=which),
                     None, False),
                    (f"whichEVP={which} whole mesh",
                     cfg23(whichEVP=which, evp_subdomain_lat=None), None,
                     False)]
    cases23 += [("tides + l_mslp", cfg23(use_global_tides=True, l_mslp=True),
                 None, False),
                ("relaxation sponge", cfg23(clim_relax=1.0 / 86400.0), None,
                 True),
                ("forcing and initial state from files", cfg23(), fdir,
                 False)]
    ice_names = ("u_ice", "v_ice", "m_ice", "a_ice", "m_snow", "sigma11",
                 "sigma12", "sigma22", "alpha_aevp", "beta_aevp", "t_skin",
                 "net_heat_flux", "fresh_wa_flux")
    rheo_cpu = {}

    def compare23(label, pairs):
        worst = 0.0
        for obj_gpu, obj_cpu, names in pairs:
            for name in names:
                ref = getattr(obj_cpu, name)
                rel = max_abs(getattr(obj_gpu, name).cpu(), ref) \
                    / max(float(ref.abs().max()), 1e-300)
                if not rel <= 1e-8:
                    fail(f"phase 23: {label} {name} card vs CPU {rel:.3e} "
                         f"> 1e-8")
                worst = max(worst, rel)
        return worst

    t23 = time.perf_counter()
    for label, cfg, fpath, sponge in cases23:
        kernels.reset_launches()
        outs = []
        for i, d in enumerate((dev, "cpu")):
            m, a = setup_pi_model(small, device=d, cfg=copy.deepcopy(cfg),
                                  forcing_path=fpath)
            s_, i_ = pi_initial_state(m, forcing_path=fpath)
            if sponge:
                lat = m.mesh.geo_coords[:, 1].abs()
                m.relax2clim = torch.where(
                    lat > np.radians(60.0),
                    torch.full_like(lat, cfg.tra.clim_relax),
                    torch.zeros_like(lat))
                m.Tclim = torch.where(m.mesh.node_layer_mask, m.Tclim + 1.0,
                                      0.0)
            s_, i_ = run_pi(m, a, s_, i_, 3)
            outs.append((s_, i_, m))
            if i == 0:
                n_card = sum(kernels.LAUNCHES.values())
        if n_card <= 0 or sum(kernels.LAUNCHES.values()) != n_card:
            fail(f"phase 23: {label}: the card's path launched no kernel, or "
                 f"the CPU path launched one")
        (s_gpu, i_gpu, m_gpu), (s_cpu, i_cpu, m_cpu) = outs
        if not (float(i_cpu.a_ice.max()) > 0.5
                and float(i_cpu.u_ice.abs().max()) > 0.0):
            fail(f"phase 23: {label}: no moving ice")
        rheo_cpu[label] = compare23(label, [
            (s_gpu, s_cpu, ("u", "v", "eta", "hbar", "tr", "w", "hnode",
                            "Kv", "Av", "fer_u")),
            (i_gpu, i_cpu, ice_names)])
        say(f"phase 23 {label}: worst field card vs cpu "
            f"{rheo_cpu[label]:.3e} of max|cpu|; {n_card} kernel launches on "
            f"the card")
    # one coupled-mode ice step (the Dorn 2009 thermodynamics on seeded
    # atmosphere-model fluxes) on the whole level-3 globe
    kernels.reset_launches()
    outs = []
    rng23 = np.random.default_rng(23)
    for i, d in enumerate((dev, "cpu")):
        m, a = setup_pi_model(small, device=d)
        s_, i_ = pi_initial_state(m)
        n_ = m.mesh.n_nodes
        if i == 0:
            fluxes = {k: rng23.uniform(lo, hi, n_) for k, (lo, hi) in dict(
                oce_heat_flux=(-300.0, 100.0), ice_heat_flux=(-150.0, 80.0),
                shortwave=(0.0, 250.0), evap_no_ifrac=(-5e-8, 0.0),
                sublimation=(-1e-8, 0.0), prec_rain=(0.0, 3e-8),
                prec_snow=(0.0, 2e-8), runoff=(0.0, 1e-9)).items()}
        put = lambda v: torch.as_tensor(v, device=d, dtype=torch.float64)
        surf = o2i(s_, m.mesh)
        ifc = update_atm_forcing(a, 0.0, i_.u_ice, i_.v_ice, surf.u_w,
                                 surf.v_w, surf.T_oc,
                                 zero_ice_forcing(m.mesh))
        cfg_c = copy.deepcopy(m.cfg)
        cfg_c.ice.evp_rheol_steps = 120
        outs.append(ice_timestep_cpl(
            i_, m.mesh, ifc, CoupledAtmFluxes(**{k: put(v) for k, v in
                                                 fluxes.items()}),
            surf, cfg_c, False, ref_sss=34.0, ref_sss_local=True))
        if i == 0:
            n_card = sum(kernels.LAUNCHES.values())
    if n_card <= 0 or sum(kernels.LAUNCHES.values()) != n_card:
        fail("phase 23: ice_timestep_cpl: the card's path launched no "
             "kernel, or the CPU path launched one")
    rheo_cpu["ice_timestep_cpl"] = compare23(
        "ice_timestep_cpl", [(outs[0], outs[1], ice_names + (
            "thdgr", "flice", "evaporation"))])
    say(f"phase 23 ice_timestep_cpl: worst field card vs cpu "
        f"{rheo_cpu['ice_timestep_cpl']:.3e} of max|cpu|; {n_card} kernel "
        f"launches on the card")
    say(f"phase 23 {len(cases23) + 1} cases in "
        f"{time.perf_counter() - t23:.1f} s")

    # phase 24 -----------------------------------------------------------
    phase_start(24, t_start)
    # the Icepack CI coupled step at full width: phase 12's tables and
    # atmosphere, cfg.run.use_icepack with the default IcepackConfig (5
    # categories, 4 ice and 4 snow layers), its EVP on the whole mesh
    icepack_kernels = ("bl99_temperature_solve", "itd_remap")
    path24 = coupled_kernels + icepack_kernels
    sweeps = []
    solve = icepack_driver._KERNELS["temperature_solve"]

    def counted_solve(*a, **k):
        out = solve(*a, **k)
        sweeps.append(out["niter"])
        return out
    icepack_driver._KERNELS["temperature_solve"] = counted_solve
    remap = icepack_driver._KERNELS["itd_remap"]

    def held_remap(checks):
        """The step's itd_remap stage with each CUDA call held bit for bit
        (NaN where NaN) against itd_remap_plain on the same inputs (the
        plain version launches no kernel); counts into ``checks``."""
        def call(*a, **k):
            out = remap(*a, **k)
            if out.is_cuda:
                want = icepack_itd.itd_remap_plain(*a, **k)
                checks["calls"] += 1
                checks["differ"] += not (
                    torch.equal(out.isnan(), want.isnan())
                    and torch.equal(out.nan_to_num(), want.nan_to_num()))
            return out
        return call
    icepack_report = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        label = f"phase 24 {tag}"
        m = icepack_models[dtype]
        step24 = pi_coupled_step_fn(m, gatm[dtype])
        st, ice, ipk = icepack_start(m)
        sweeps.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        hbar_expected = 0.0
        # both itd_remap calls of every gated step held against plain
        remap_checks = {"calls": 0, "differ": 0}
        icepack_driver._KERNELS["itd_remap"] = held_remap(remap_checks)
        t0 = time.perf_counter()
        for k in range(10):
            st, ice, ipk, oforc = step24(st, ice, k, ipk)
            hbar_expected = hbar_expected - m.cfg.dt * (
                oforc.water_flux * area).sum() / area.sum()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        icepack_driver._KERNELS["itd_remap"] = remap
        n_same = remap_checks["calls"] - remap_checks["differ"]
        say(f"{label} itd_remap bit-equal to its plain version on the "
            f"step's own inputs: {n_same} of {remap_checks['calls']} calls "
            f"(the wall time and peak memory below include the plain "
            f"calls)")
        if remap_checks["differ"] or remap_checks["calls"] != 20:
            fail(f"{label}: itd_remap against its plain version in the "
                 f"steps: {remap_checks}")
        launch = {k: kernels.LAUNCHES[k] for k in path24}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_sweeps = [int(x) for x in sweeps]
        say(f"{label} 10 Icepack coupled steps on the level-7 globe: "
            f"{wall:.3f} s, launches {launch}, BL99 sweeps a step "
            f"{n_sweeps}, peak memory allocated {peak:.2f} GiB, "
            f"{peak - base:.2f} GiB above the {base:.2f} held before the "
            f"steps ({card})")
        check_globe(label, m, st, launch, float(hbar_expected))
        for name_, obj in (("ice", ice), ("ipk", ipk)):
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if v is not None and not bool(torch.isfinite(v).all()):
                    fail(f"{label}: {name_}.{f.name} is not finite")
        asum = float(ipk.aicen.sum(0).max())
        # the category sum of a float32 state is bounded by its rounding
        a_lim = 1.0 + (1e-12 if dtype == torch.float64 else 2.0 ** -22)
        say(f"{label} aicen in [{float(ipk.aicen.min()):.3e}, "
            f"{float(ipk.aicen.max()):.6f}], category sum up to {asum!r}, "
            f"min vicen {float(ipk.vicen.min()):.3e}, min vsnon "
            f"{float(ipk.vsnon.min()):.3e}, ice area "
            f"{float((ice.a_ice * area).sum()):.6e} m^2, volume "
            f"{float((ice.m_ice * area).sum()):.6e} m^3, max|u_ice| "
            f"{float(ice.u_ice.abs().max()):.4f} m/s")
        if not (float(ipk.aicen.min()) >= 0.0 and float(ipk.aicen.max())
                <= 1.0 and asum <= a_lim and float(ipk.vicen.min()) >= 0.0
                and float(ipk.vsnon.min()) >= 0.0):
            fail(f"{label}: aicen, its category sum, vicen or vsnon out of "
                 f"range")
        if not float(ice.a_ice.max()) > 0.5:
            fail(f"{label}: no node with a_ice > 0.5")
        want = {"bl99_temperature_solve": 10, "itd_remap": 20,
                "mevp_subcycles": 10}
        bad = {k: launch[k] for k, v in want.items() if launch[k] != v}
        if bad:
            fail(f"{label}: launches in 10 steps {bad}, expected {want}")
        if dtype == torch.float64:
            for k in icepack_kernels:
                path_launches[k] = launch[k]
        # coupled steps a second: 10 steps after these 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ice, ipk = run_pi(m, gatm[dtype], st, ice, 10, first_step=10,
                              ipk=ipk)
        torch.cuda.synchronize()
        rate = 10 / (time.perf_counter() - t0)
        say(f"{label} throughput: {rate:.3f} Icepack coupled steps/s "
            f"(phase 12's CI step: {ci_rates.get(tag, 0.0):.3f}; {card})")
        # a 3-step profile: device and host ms a step per span
        dev_sp, host_sp, cnt_sp = {}, {}, {}
        # the copies torch.cat and torch.stack launch, by span: itd_remap
        # reads the category tensors where they lie, so its two calls add
        # none (the first design's packed state cost a stack and a cat a
        # call, under thermo2 and under ridging)
        cat_sp = {"CatArrayBatchedCopy": {}}
        kernels.reset_launches()
        profile_steps(label, m, st, 3, card,
                      run=lambda m_, st_, k, a=gatm[dtype], i=ice, p=ipk:
                      run_pi(m_, a, st_, i, k, first_step=20, ipk=p),
                      also=("bl99", "itd_remap", "mevp"), spans=dev_sp,
                      host_spans=host_sp, span_counts=cnt_sp,
                      span_named=cat_sp)
        prof_launch = {k: kernels.LAUNCHES[k] / 3 for k in path24}
        if prof_launch["bl99_temperature_solve"] != 1 \
                or prof_launch["itd_remap"] != 2:
            fail(f"{label}: in the profiled steps {prof_launch}")
        spans = {k: {"device_ms": dev_sp.get(k), "host_ms": host_sp.get(k),
                     "kernels": cnt_sp.get(k),
                     "cat_kernels": cat_sp["CatArrayBatchedCopy"].get(k, 0)}
                 for k in sorted(set(dev_sp) | set(host_sp))
                 if k.startswith("step.icepack")}
        for k, v in spans.items():
            say(f"{label} {k}: device {us_text(v['device_ms'])} ms, host "
                f"{us_text(v['host_ms'])} ms, {v['kernels']} kernels a step, "
                f"{v['cat_kernels']} of them torch.cat/stack copies")
        span_ms.setdefault("icepack", {})[tag] = dev_sp
        icepack_report[tag] = dict(
            coupled_steps_per_s=rate, ci_coupled_steps_per_s=ci_rates.get(tag),
            sweeps_a_step=n_sweeps, launches_10_steps=launch,
            launches_per_profiled_step=prof_launch, peak_memory_gib=peak,
            memory_before_gib=base,
            icepack_spans=spans, aicen_category_sum_max=asum)
    icepack_driver._KERNELS["temperature_solve"] = solve

    # phase 25 -----------------------------------------------------------
    phase_start(25, t_start)
    # card against CPU on the level-3 globe, 3 float64 Icepack coupled
    # steps each (4 with ice_ave_steps = 2): every field of the ocean, the
    # ice and the IcepackState within 1e-8 of max|CPU|, no kernel on the
    # CPU path
    cases25 = (("default", {}, {}),
               ("ponds + age + FY + lvl", dict(tr_pond_cesm=True,
                                               tr_iage=True, tr_FY=True,
                                               tr_lvl=True), {}),
               ("dEdd", dict(shortwave="dEdd"), {}),
               ("fsd", dict(tr_fsd=True), {}),
               ("bgc", dict(tr_bgc=True), {}),
               ("ice_ave_steps = 2", {}, dict(ice_ave_steps=2)))
    t25 = time.perf_counter()
    for label, opts, ice_knobs in cases25:
        cfg = port_model.pi_config()
        for k, v in ice_knobs.items():
            setattr(cfg.ice, k, v)
        cfg.run.use_icepack = True
        cfg.icepack = IcepackConfig(**opts)
        n = 4 if ice_knobs else 3
        kernels.reset_launches()
        outs = []
        # the card's itd_remap calls held bit for bit against plain
        remap_checks = {"calls": 0, "differ": 0}
        for i, d in enumerate((dev, "cpu")):
            m, a = setup_pi_model(small, device=d, cfg=copy.deepcopy(cfg))
            s_, i_, p_ = icepack_start(m)
            icepack_driver._KERNELS["itd_remap"] = held_remap(remap_checks)
            outs.append(run_pi(m, a, s_, i_, n, ipk=p_))
            icepack_driver._KERNELS["itd_remap"] = remap
            if i == 0:
                n_card = sum(kernels.LAUNCHES.values())
                n24 = {k: kernels.LAUNCHES[k] for k in icepack_kernels}
        if n_card <= 0 or sum(kernels.LAUNCHES.values()) != n_card \
                or min(n24.values()) <= 0:
            fail(f"phase 25: {label}: the card's path launched no Icepack "
                 f"kernel, or the CPU path launched one")
        if remap_checks["differ"] \
                or remap_checks["calls"] != n24["itd_remap"]:
            fail(f"phase 25: {label}: itd_remap against its plain version "
                 f"{remap_checks}, {n24['itd_remap']} launches")
        (s_gpu, i_gpu, p_gpu), (s_cpu, i_cpu, p_cpu) = outs
        pairs = [(s_gpu, s_cpu, ("u", "v", "eta", "hbar", "tr", "w",
                                 "hnode", "Kv", "Av")),
                 (i_gpu, i_cpu, ice_names),
                 (p_gpu, p_cpu, tuple(f.name for f in dataclasses.fields(
                     p_cpu) if getattr(p_cpu, f.name) is not None
                     and getattr(p_cpu, f.name).numel()))]
        worst = 0.0
        for obj_gpu, obj_cpu, names in pairs:
            for name in names:
                ref = getattr(obj_cpu, name)
                rel = max_abs(getattr(obj_gpu, name).cpu(), ref) \
                    / max(float(ref.abs().max()), 1e-300)
                if not rel <= 1e-8:
                    fail(f"phase 25: {label} {name} card vs CPU {rel:.3e} "
                         f"> 1e-8")
                worst = max(worst, rel)
        icepack_cpu[label] = worst
        say(f"phase 25 {label}: worst field card vs cpu {worst:.3e} of "
            f"max|cpu|; {n_card} kernel launches on the card ({n24}); "
            f"itd_remap bit-equal to plain in {remap_checks['calls']} calls")
    say(f"phase 25 {len(cases25)} cases in {time.perf_counter() - t25:.1f} s")

    # phase 26 -----------------------------------------------------------
    phase_start(26, t_start)
    # the run's output path at full width: phase 12's tables and
    # atmosphere with the DVD, the density-space MOC, the energy fields,
    # the stress curl, the 3D vorticity and the salt integral on; run_pi
    # with the default streams and the diagnostic streams hourly (a flush
    # every 4 steps), restarts every 5 steps
    import shutil
    from fesom2_tpu_torch.io import restart as restart_io
    from fesom2_tpu_torch.io.netcdf import read_vars
    from fesom2_tpu_torch.io import streams as streams_io
    from fesom2_tpu_torch.run import RunTimers
    out_root = Path(__file__).resolve().parent / "build" / "chip_smoke" \
        / "output"
    shutil.rmtree(out_root, ignore_errors=True)
    diag_flags = ("ldiag_DVD", "ldiag_dMOC", "ldiag_energy",
                  "lcurt_stress_surf", "ldiag_curl_vel3", "ldiag_salt3D")
    diag_ids = ("dvd_temp_h", "dvd_temp_v", "dvd_salt_h", "dvd_salt_v",
                "std_dens_UDZ", "std_dens_VDZ", "std_dens_VOL", "std_dens_Z",
                "std_dens_W", "curl_u", "density_flux_e")

    def diag_model(m):
        """The CI model ``m`` with every &diag_list flag on, on m's
        tables."""
        cfg = copy.deepcopy(m.cfg)
        for flag in diag_flags:
            setattr(cfg.diag, flag, True)
        return Model(m.mesh, cfg, m.tracer_statics, m.density_ref,
                     ice_sub=m.ice_sub, ssh_dense_inv=m.ssh_dense_inv,
                     ssh_ring=m.ssh_ring, ssh_block_pc=m.ssh_block_pc)

    def output_defs(m, unit="h", freq=1, with_fw=True):
        """The default ocean and ice streams and the diagnostic streams,
        every ``freq`` ``unit``; with ``with_fw``, the water flux over the
        whole run (10 steps), for the volume gate."""
        defs = streams_io.default_ocean_streams(m.mesh) \
            + streams_io.default_ice_streams() \
            + [streams_io.make_stream(sid, m.mesh, m.cfg) for sid in diag_ids]
        for d in defs:
            d.unit, d.freq = unit, freq
        if not with_fw:
            return defs
        return defs + [streams_io.make_stream("fw", m.mesh, m.cfg, freq=10,
                                              unit="s")]

    m26 = {dtype: diag_model(gm[dtype]) for dtype in (torch.float64,
                                                      torch.float32)}
    m = m26[torch.float64]
    mesh26 = m.mesh
    run_dir = str(out_root / "run")
    st0, ice0 = pi_initial_state(m)
    torch.cuda.synchronize()
    base26 = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    timers26 = RunTimers()
    t0 = time.perf_counter()
    st, ice = run_pi(m, gatm[torch.float64], st0, ice0, 10,
                     result_path=run_dir, restart_every=5,
                     stream_defs=output_defs(m), timers=timers26)
    torch.cuda.synchronize()
    wall26 = time.perf_counter() - t0
    peak26 = torch.cuda.max_memory_allocated() / 2 ** 30
    launch26 = {k: kernels.LAUNCHES[k] for k in coupled_kernels
                + ("dens_moc_bin",)}
    path_launches["dens_moc_bin"] = launch26["dens_moc_bin"]
    rates26 = {"float64": 10 / wall26}
    say(f"phase 26 10 float64 coupled steps with the output path: "
        f"{wall26:.3f} s ({rates26['float64']:.3f} coupled steps/s; phase "
        f"12's {ci_rates.get('float64', 0.0):.3f}), step {timers26.step:.3f}"
        f" s, output host {timers26.output * 100:.3f} ms a step (update_means"
        f" and flushes), restarts {timers26.restart:.3f} s, launches "
        f"{launch26}, peak memory allocated {peak26:.2f} GiB ({base26:.2f} "
        f"held before; {card})")
    if launch26["dens_moc_bin"] != 10:
        fail(f"phase 26: dens_moc_bin launched {launch26['dens_moc_bin']} "
             f"times in 10 steps, not once a step")
    fw = read_vars(os.path.join(run_dir, "fw.fesom.1948.nc"), ["fw"])["fw"]
    fw_mean = torch.as_tensor(fw[0].astype(np.float64), device=dev)
    hbar26 = float(-m.cfg.dt * 10 * (fw_mean * area).sum() / area.sum())
    check_globe("phase 26", m, st, launch26, hbar26)
    check_ice("phase 26", m, st, ice, ice0, n_steps=10)
    for name in ("dvd_h", "dvd_v"):
        x = getattr(st, name)
        if not (x.shape[0] == 2 and bool(torch.isfinite(x).all())
                and float(x.abs().max()) > 0.0):
            fail(f"phase 26: {name} {list(x.shape)} not finite or all 0")
    # the diagnostics of the final state (the forcing of the next step)
    f26 = pi_coupled_step_fn(m, gatm[torch.float64])(st, ice, 10)[2]
    diag26 = diagnostics.compute_diagnostics(st, mesh26, m.cfg, f26)
    lmask = mesh26.elem_layer_mask
    vol = float((torch.where(lmask, st.helem, 0.0)
                 * mesh26.elem_area).sum())
    udz = float(torch.where(lmask, st.u * st.helem, 0.0).sum())
    gates26 = {
        "std_dens_VOL": (float(diag26["std_dens_VOL"].sum()), vol, 1e-10),
        "std_dens_UDZ": (float(diag26["std_dens_UDZ"].sum()), udz, 1e-8)}
    w_err = float((diag26["std_dens_W"].sum(0) - lmask.sum(0)).abs().max())
    for k, (got, want, tol) in gates26.items():
        say(f"phase 26 sum of {k} {got!r} against {want!r}: relative "
            f"{abs(got - want) / abs(want):.3e} (gate {tol})")
        if not abs(got - want) <= tol * abs(want):
            fail(f"phase 26: {k} sums to {got!r}, not {want!r}")
    say(f"phase 26 std_dens_W summed over the classes against each "
        f"element's active layers: max err {w_err:.3e} (gate 1e-12); "
        f"diagnostics {sorted(diag26)}")
    if not w_err <= 1e-12 or not all(bool(torch.isfinite(v).all())
                                     for v in diag26.values()):
        fail("phase 26: std_dens_W off the layer count, or a diagnostic is "
             "not finite")
    names26 = [d.name for d in output_defs(m)]
    missing = [n for n in names26 if not os.path.exists(
        os.path.join(run_dir, f"{n}.fesom.1948.nc"))] + [
        n for n in ("fesom.mesh.diag.nc", "fesom.clock", "restart.nc")
        if not os.path.exists(os.path.join(run_dir, n))]
    if missing:
        fail(f"phase 26: files not written: {missing}")
    # sst's and a_ice's hourly records against means accumulated here, on
    # the same 8 steps taken again
    step26 = pi_coupled_step_fn(m, gatm[torch.float64])
    s_, i_ = st0, ice0
    acc = {"sst": [], "a_ice": []}
    for k in range(8):
        s_, i_, _ = step26(s_, i_, k)
        acc["sst"].append(s_.tr[0, 0])
        acc["a_ice"].append(i_.a_ice)
    for name, vals in acc.items():
        rec = read_vars(os.path.join(run_dir, f"{name}.fesom.1948.nc"),
                        [name])[name]
        own = np.stack([(sum(vals[:4]) / 4).cpu().numpy(),
                        (sum(vals[4:]) / 4).cpu().numpy()])
        rel = float(np.abs(rec - own).max() / np.abs(own).max())
        say(f"phase 26 {name}: {rec.shape[0]} hourly records against the "
            f"phase's own means: {rel:.3e} of max (gate 1e-12)")
        if rec.shape[0] != 2 or not rel <= 1e-12:
            fail(f"phase 26: {name}'s records differ from the means")
    # resume: 5 steps with a restart, then on to step 10
    res_dir = str(out_root / "resume")
    run_pi(m, gatm[torch.float64], *pi_initial_state(m), 5,
           result_path=res_dir, restart_every=5, stream_defs=output_defs(m))
    sr, ir = run_pi(m, gatm[torch.float64], *pi_initial_state(m), 10,
                    result_path=res_dir, resume=True,
                    stream_defs=output_defs(m))
    differ = {}
    for obj_r, obj, cls in ((sr, st, type(st)), (ir, ice, type(ice))):
        for f in dataclasses.fields(cls):
            a_, b_ = getattr(obj_r, f.name), getattr(obj, f.name)
            if not torch.equal(a_, b_):
                differ[f.name] = max_abs(a_, b_) / max(
                    float(b_.abs().max()), 1e-300)
    say(f"phase 26 resumed at step 5 to 10 against the unbroken 10 steps: "
        f"{'bitwise' if not differ else differ}")
    if any(not v <= 1e-12 for v in differ.values()):
        fail(f"phase 26: the resumed run differs: {differ}")
    # a state with a NaN in eta
    nan_dir = str(out_root / "blowup")
    eta = st0.eta.clone()
    eta[100] = float("nan")
    try:
        run_pi(m, gatm[torch.float64], dataclasses.replace(st0, eta=eta),
               ice0, 2, result_path=nan_dir, stream_defs=[])
        fail("phase 26: a NaN in eta did not raise")
    except RuntimeError as err:
        say(f"phase 26 a NaN in eta raises: {str(err)[:160]}")
        if "blowup detected at step 1" not in str(err) or not \
                os.path.exists(os.path.join(nan_dir, "blowup.nc")):
            fail(f"phase 26: the blowup did not name step 1 or left no "
                 f"blowup.nc: {err}")
    # float32: coupled steps/s with all of it on
    t0 = time.perf_counter()
    m = m26[torch.float32]
    timers32 = RunTimers()
    s32, _ = run_pi(m, gatm[torch.float32], *pi_initial_state(m), 10,
                    result_path=str(out_root / "run32"), restart_every=5,
                    stream_defs=output_defs(m), timers=timers32)
    torch.cuda.synchronize()
    rates26["float32"] = 10 / (time.perf_counter() - t0)
    if not bool(torch.isfinite(s32.dvd_h).all()):
        fail("phase 26: float32 dvd_h not finite")
    say(f"phase 26 10 float32 coupled steps with the output path: "
        f"{rates26['float32']:.3f} coupled steps/s (phase 12's "
        f"{ci_rates.get('float32', 0.0):.3f}), output host "
        f"{timers32.output * 100:.3f} ms a step, restarts "
        f"{timers32.restart:.3f} s ({card})")
    # update_means alone: host ms of a call, and wall ms to its end
    outs = streams_io.OutputStreams(output_defs(m26[torch.float64]),
                                    str(out_root / "means"))
    host_ms, wall_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.update_means(st, ice, None, f26)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    outs.finalize()
    means_ms = {"host_ms": sorted(host_ms)[2], "wall_ms": sorted(wall_ms)[2]}
    say(f"phase 26 update_means with {len(outs.defs)} streams: host "
        f"{means_ms['host_ms']:.3f} ms a call, {means_ms['wall_ms']:.3f} ms "
        f"to the card's end ({card})")
    # a 3-step profile: the DVD span, the output span and dens_moc_bin
    out26 = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        m = m26[dtype]
        sp, host_sp = {}, {}
        s_p, i_p = pi_initial_state(m)
        # hourly, as the run above: no flush in the 3 profiled steps
        defs_p = output_defs(m, with_fw=False)
        us = profile_steps(
            "phase 26", m, s_p, 3, card,
            run=lambda m_, st_, k, a=gatm[dtype], i=i_p, d=defs_p: run_pi(
                m_, a, st_, i, k, result_path=str(out_root / f"prof_{tag}"),
                stream_defs=d),
            also=("dens_moc_bin",), spans=sp, host_spans=host_sp)
        dmoc_ms = sum(v for key, v in us.items()
                      if "dens_moc_bin" in key) / 1e3 or None
        out26[tag] = {
            "coupled_steps_per_s": rates26[tag],
            "ci_coupled_steps_per_s": ci_rates.get(tag),
            "dvd_device_ms": sp.get("step.tracers.dvd"),
            "dvd_host_ms": host_sp.get("step.tracers.dvd"),
            "output_device_ms": sp.get("step.output"),
            "output_host_ms": host_sp.get("step.output"),
            "dens_moc_bin_device_ms": dmoc_ms}
        say(f"phase 26 {tag} a step: DVD span device "
            f"{us_text(sp.get('step.tracers.dvd'))} ms, output span device "
            f"{us_text(sp.get('step.output'))} ms, dens_moc_bin device "
            f"{us_text(dmoc_ms)} ms ({card})")
    out26["float64"].update(
        output_host_ms_a_step=timers26.output * 100,
        restart_s=timers26.restart, peak_memory_gib=peak26,
        memory_before_gib=base26, update_means=means_ms,
        resume_differs=differ, gates=gates26,
        std_dens_W_err=w_err)
    summary["dens_moc_bin"]["output_step_device_ms"] = {
        tag: v["dens_moc_bin_device_ms"] for tag, v in out26.items()}
    # the 10-step run's directory stays for phase 30's post-processing
    post_dir = str(out_root.parent / "post_run")
    shutil.rmtree(post_dir, ignore_errors=True)
    shutil.move(run_dir, post_dir)
    shutil.rmtree(out_root, ignore_errors=True)

    # phase 27 -----------------------------------------------------------
    phase_start(27, t_start)
    # card against CPU on the level-3 globe: 3 float64 coupled steps with
    # every &diag_list flag on, through run_pi with the streams (flushed
    # at the end) and a restart
    cfg = port_model.pi_config()
    for flag in diag_flags:
        setattr(cfg.diag, flag, True)
    sides = {}
    for d in (dev, "cpu"):
        tag = "card" if d == dev else "cpu"
        m, a = setup_pi_model(small, device=d, cfg=copy.deepcopy(cfg))
        kernels.reset_launches()
        s_, i_ = run_pi(m, a, *pi_initial_state(m), 3,
                        result_path=str(out_root / tag), restart_every=3,
                        stream_defs=output_defs(m, unit="s", freq=3,
                                                with_fw=False))
        f_ = pi_coupled_step_fn(m, a)(s_, i_, 3)[2]
        sides[tag] = (m, s_, i_, diagnostics.compute_diagnostics(
            s_, m.mesh, m.cfg, f_), sum(kernels.LAUNCHES.values()))
    (mg, sg, ig, dg_, n_card), (mc, sc, ic, dc, n_cpu) = sides.values()
    if n_card <= 0 or n_cpu != 0:
        fail(f"phase 27: {n_card} launches on the card, {n_cpu} on the CPU")
    worst27 = {}
    pairs = [(f"state.{n}", getattr(sg, n), getattr(sc, n))
             for n in ("dvd_h", "dvd_v", "tr", "u", "eta")] \
        + [(f"diag.{k}", dg_[k], dc[k]) for k in dc]
    for label, g, c in pairs:
        rel = max_abs(g.cpu(), c) / max(float(c.abs().max()), 1e-300)
        worst27[label] = rel
        if not rel <= 1e-8:
            fail(f"phase 27: {label} card vs CPU {rel:.3e} > 1e-8")
    # the card's restart read on the CPU: the card's state, bit for bit
    rs, ri = restart_io.read_restart(str(out_root / "card" / "restart.nc"),
                                     *pi_initial_state(mc))
    for n in restart_io.OCE_FIELDS:
        if not torch.equal(getattr(rs, n), getattr(sg, n).cpu()):
            fail(f"phase 27: the card's restart read on the CPU: {n} differs")
    for n in restart_io.ICE_FIELDS:
        if not torch.equal(getattr(ri, n), getattr(ig, n).cpu()):
            fail(f"phase 27: the card's restart read on the CPU: ice {n} "
                 f"differs")
    for d in output_defs(mc, unit="s", freq=3, with_fw=False):
        fname = f"{d.name}.fesom.1948.nc"
        g = read_vars(str(out_root / "card" / fname), [d.name])[d.name]
        c = read_vars(str(out_root / "cpu" / fname), [d.name])[d.name]
        rel = float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-300))
        worst27[f"stream.{d.name}"] = rel
        if not rel <= 1e-8:
            fail(f"phase 27: stream {d.name} card vs CPU {rel:.3e} > 1e-8")
    say(f"phase 27 level-3 globe, 3 coupled steps with the diagnostics: "
        f"worst card vs cpu {max(worst27.values()):.3e} of max|cpu| over "
        f"{len(worst27)} fields, diagnostics and streams; the card's "
        f"restart read on the CPU bitwise; {n_card} kernel launches on the "
        f"card, none on the CPU")
    shutil.rmtree(out_root, ignore_errors=True)

    # phases 30-32 (before phase 28, which turns phase 12's models to the
    # distributed formulation) ----------------------------------------------
    post_report = phase30(post_dir, gm[torch.float64].mesh, card, t_start)
    shutil.rmtree(post_dir, ignore_errors=True)
    coupler_report = phase31(gm, gatm, small, card, t_start)
    profile_report = phase32(globe_path, span_ms, coupled_kernels, card,
                             t_start)

    # phase 28 -----------------------------------------------------------
    # two more processes share the card: the earlier phases' models,
    # phase 12's (gm) apart, are let go first
    for held in (chan, big, gf, sm, rm, icepack_models, m26, truns, cruns,
                 fruns, sruns):
        held.clear()
    del fm
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    dist_report = phase28(gm, gatm, small, card, t_start)
    # phase 29 -----------------------------------------------------------
    mkrun_report = phase29(globe_path, card, t_start)

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
               "mevp_subcycles": "fesom2_tpu/ice/evp.py:83",
               "evp_subcycles": "fesom2_tpu/ice/evp.py:192",
               "aevp_subcycles": "fesom2_tpu/ice/evp.py:305",
               "bl99_temperature_solve":
                   "fesom2_tpu/ice/icepack/thermo_vertical.py:142",
               "itd_remap": "fesom2_tpu/ice/icepack/itd.py:167",
               "dens_moc_bin": "fesom2_tpu/core/diagnostics.py:159"}
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
    say(json.dumps({"span_device_ms_a_step": span_ms,
                    "menus_card_vs_cpu": menu_report,
                    "refined_l6": {"coupled_steps_per_s": refined_rate,
                                   "device_us": refined_us},
                    "tke_idemix": {"coupled_steps_per_s": tke_rate,
                                   "peak_memory_gib": peak_gb,
                                   "memory_before_gib": base_gb,
                                   "region_nodes": region_nodes,
                                   "span_host_ms_a_step": tke_host,
                                   "span_kernels_a_step": tke_counts,
                                   "passive_bounds_redi": bounds,
                                   "passive_bounds_no_redi": nr_bounds},
                    "slice_menus_card_vs_cpu": slice_report,
                    "evp_variants": rheo_report,
                    "forcing_from_files": files_report,
                    "slice14_card_vs_cpu": rheo_cpu,
                    "icepack": {"bl99": bl99_report, "steps": icepack_report,
                                "card_vs_cpu": icepack_cpu},
                    "output_path": {"steps": out26,
                                    "card_vs_cpu": worst27,
                                    "dens_moc_bin_counts": dmoc_counts},
                    "dist": dist_report, "mkrun": mkrun_report,
                    "post": post_report, "coupler": coupler_report,
                    "profile_pi_phases": profile_report}))
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
         "launches_per_dist_coupled_step": [
             r.get(k, 0) for r in
             dist_report["gloo_float64"]["launches_a_step"]],
         "step_device_us_a_launch": per_launch_us["float64"].get(k),
         "step_device_us_a_launch_f32": per_launch_us["float32"].get(k),
         "step_device_ms": step_ms["float64"].get(k),
         "step_device_ms_f32": step_ms["float32"].get(k),
         "launches_per_fast_coupled_step": per_fast_step.get(k),
         "launches_per_fast_coupled_step_f32":
             fast_launches["float32"].get(k),
         "fast_step_device_ms": fast_ms["float64"].get(k),
         "fast_step_device_ms_f32": fast_ms["float32"].get(k),
         "launches_per_shelf_coupled_step": per_shelf_step.get(k),
         "shelf_step_device_ms": shelf_ms["float64"].get(k),
         "shelf_step_device_ms_f32": shelf_ms["float32"].get(k),
         "launches_per_tke_coupled_step": per_tke_step.get(k),
         "launches_per_tke_coupled_step_f32":
             tke_launches_dtype["float32"].get(k),
         "tke_step_device_ms": tke_ms["float64"].get(k),
         "tke_step_device_ms_f32": tke_ms["float32"].get(k),
         **({"shapes": summary[k]["shapes"]} if "shapes" in summary[k]
            else {}),
         **{key: summary[k][key] for key in ("barrier_floor_ms", "plan",
                                             "whole_mesh_barrier_floor_ms",
                                             "whole_mesh_plan",
                                             "loop_ms_a_step",
                                             "output_step_device_ms",
                                             "solve_kernel_vs_plain")
            if key in summary[k]},
         **({"shapes_step_device_ms": step_rows[k]} if k in step_rows
            else {})}
        for k in kernels.KERNELS]}))
    total = time.perf_counter() - t_start
    say(json.dumps({"phase_wall_s": phase_walls(total)}))
    say(f"chip_smoke took {total:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
