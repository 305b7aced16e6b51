"""What decides ``correct``: the plain reference (``reference/fesom``, a
frozen plain-torch copy of the model at git e5ef625 that imports nothing of
the program) set up on its own from the cell's mesh files, configuration
and seed, and comparisons with what the timed path produced.

- ``start_gap``: the reference's first call of steps from its own set-up
  and initial state, against the program's first call (the warm-up, the
  same ``run_pi`` call the window makes): the mesh tables, statics, SSH
  operator, inputs and the steps all worked out again.
- ``step_gap``: the reference's steps from the program's own state at the
  start of the window's last call, against the program's state at its end.

Each is the widest gap over the compared fields, max|program - reference|
over max|reference| of the field (NaN reads infinite).  The configuration
names the fields (``compare``): the ocean's eta, hbar, u, v, w and each
tracer; the ice's area, ice mass and snow mass, and in the CI configuration
its velocity; under Icepack each category's area, ice volume and snow
volume, and each layer's energy of ice and snow per unit area.

A field is left out (the configuration's ``left_out`` says why) where sound
runs read it at or above the control's smallest, or too near it to hold:
under Icepack the surface temperatures, the enthalpies per volume and the
ice velocity, which thresholds set (PERF.md gives the readings).  What they
do reaches the compared fields within the call: the temperatures grow and
melt the ice, the velocity moves it.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

# every field a reading may show (``gap_table``); "*": each of the group's
EVERY = {"ocean": ["eta", "hbar", "u", "v", "w", "tr"],
         "ice": ["a_ice", "m_ice", "m_snow", "u_ice", "v_ice"],
         "icepack": "*"}

# Icepack fields worked out from two of its state's: each layer's energy
# per unit area, (enthalpy [ncat, nlyr, N], the category's volume [ncat, N])
# -> enthalpy x volume / nlyr.  It goes to nought with the volume, where the
# enthalpy of a vanishing category is set by a threshold
ENERGY = {"eicen": ("qin", "vicen"), "esnon": ("qsn", "vsnon")}


def energy(ipk: dict, name: str) -> torch.Tensor:
    """The field ``name`` of ``ENERGY`` from a snapshot's Icepack state."""
    q, vol = (ipk[k].to(torch.float64) for k in ENERGY[name])
    return q * vol.unsqueeze(1) / q.shape[1]


def snapshot(state, ice, ipk=None) -> dict:
    """Every tensor field of the three states, on the host."""
    out = {}
    for tag, obj in (("ocean", state), ("ice", ice), ("ipk", ipk)):
        if obj is None:
            continue
        out[tag] = {f.name: getattr(obj, f.name).detach().to("cpu", copy=True)
                    for f in dataclasses.fields(obj)
                    if isinstance(getattr(obj, f.name), torch.Tensor)}
    return out


def compared(snap: dict, fields: dict) -> dict:
    """The fields of a snapshot that ``fields`` names ({"ocean": [...],
    "ice": [...], "icepack": [...] or "*"}), by name, the tracers one by
    one."""
    out = {}
    for k in fields.get("ocean", []):
        x = snap["ocean"][k]
        if k == "tr":
            out.update({f"tr{i}": x[i] for i in range(x.shape[0])})
        else:
            out[k] = x
    out.update({k: snap["ice"][k] for k in fields.get("ice", [])})
    ipk = snap.get("ipk")
    if ipk is None:
        return out
    keep = fields.get("icepack", [])
    if keep == "*":
        keep = list(ipk) + list(ENERGY)
    out.update({f"icepack.{k}": ipk[k] if k in ipk else energy(ipk, k)
                for k in keep})
    return out


def gap_table(prog: dict, ref: dict) -> dict:
    """Per field: the widest gap, the root-mean-square gap (over the rms of
    the reference's field) and the entries whose gap exceeds 1e-9 of the
    field's largest value."""
    out = {}
    p, r = compared(prog, EVERY), compared(ref, EVERY)
    for k, rv in r.items():
        pv = p[k].to(torch.float64)
        rv = rv.to(torch.float64)
        d = (pv - rv).abs()
        scale = float(rv.abs().max())
        rms = float(rv.square().mean().sqrt())
        out[k] = (float(d.max()) / scale if scale > 0 else float(d.max()),
                  float(d.square().mean().sqrt()) / rms if rms > 0
                  else float(d.max()),
                  int((d > 1e-9 * scale).sum()), int(d.numel()))
    return out


def state_gap(prog: dict, ref: dict, fields: dict) -> tuple:
    """(widest gap, the field it is in) of two snapshots over ``fields``
    (as ``compared`` reads them)."""
    worst, where = 0.0, ""
    p, r = compared(prog, fields), compared(ref, fields)
    for k, rv in r.items():
        pv = p[k].to(torch.float64)
        rv = rv.to(torch.float64)
        scale = float(rv.abs().max()) if rv.numel() else 0.0
        diff = float((pv - rv).abs().max()) if rv.numel() else 0.0
        if not math.isfinite(diff) or not torch.isfinite(pv).all():
            return math.inf, k
        g = diff / scale if scale > 0 else diff
        if g > worst:
            worst, where = g, k
    return worst, where


class Reference:
    """The plain reference of one cell on ``device`` in ``dtype``."""

    def __init__(self, mesh_path: str, cell, seed: int, device, dtype):
        from .reference.fesom import model as R
        from . import spec
        self.R = R
        self.device, self.dtype = torch.device(device), dtype
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        phys = cell.config["physics"]
        cfg = R.pi_config(phys["parity"], phys["step_per_day"])
        self.icepack = cell.config.get("icepack")
        spec.apply_config(cfg, cell)
        if self.icepack is not None:
            from .reference.fesom.ice.icepack import IcepackConfig
            cfg.icepack = IcepackConfig(**self.icepack.get("opts", {}))
            cfg.run.use_icepack = True
            spec.check_icepack(cfg.icepack, cell)
        self.model, _ = R.setup_pi_model(mesh_path, device=device,
                                         dtype=dtype, cfg=cfg, atm_seed=seed)
        self.n_records = cell.traffic["atm_records"]
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        """The atmosphere and initial state of another seed, on the same
        tables."""
        self.seed = seed
        self.atm = self.R.globe_atm_data(self.model, seed,
                                         n_records=self.n_records)
        self.step = self.R.pi_coupled_step_fn(self.model, self.atm)

    def initial(self):
        """(state, ice, Icepack state or None) from the seed, as the
        program's ``pi_initial_state`` and ``run_pi`` start them."""
        state, ice = self.R.pi_initial_state(self.model, seed=self.seed)
        ipk = None
        if self.icepack is not None:
            from .reference.fesom.ice.icepack import init_icepack_state
            ipk = init_icepack_state(self.model.cfg.icepack, ice.a_ice,
                                     ice.m_ice, ice.m_snow, ice.t_skin,
                                     dtype=self.dtype)
        return state, ice, ipk

    def load(self, snap: dict):
        """A snapshot as the reference's own state types, on its device and
        in its dtype."""
        from .reference.fesom.core.state import OceanState
        from .reference.fesom.ice.state import IceState

        def put(x):
            x = x.to(self.device)
            return x.to(self.dtype) if x.is_floating_point() else x

        def build(cls, fields):
            kw = {f.name: None for f in dataclasses.fields(cls)}
            kw.update({k: put(v) for k, v in fields.items()})
            return cls(**kw)
        ipk = None
        if "ipk" in snap:
            from .reference.fesom.ice.icepack.state import IcepackState
            ipk = build(IcepackState, snap["ipk"])
        return (build(OceanState, snap["ocean"]), build(IceState, snap["ice"]),
                ipk)

    def steps(self, state, ice, ipk, first: int, n: int):
        """``n`` coupled steps from step index ``first``."""
        with torch.no_grad():
            for k in range(first, first + n):
                out = self.step(state, ice, k, ipk) if ipk is not None \
                    else self.step(state, ice, k)
                state, ice = out[0], out[1]
                if ipk is not None:
                    ipk = out[2]
        return state, ice, ipk


def mesh_sizes(model, itemsize: int) -> dict:
    """The configuration's sizes, from the reference's tables of its mesh
    files: nodes, elements, levels, wet node-levels, element-levels and
    node-interfaces."""
    m = model.mesh
    nln, uln = m.nlevels_node.long(), m.ulevels_node.long()
    nle, ule = m.nlevels_elem.long(), m.ulevels_elem.long()
    return {"n_nodes": int(m.n_nodes), "n_elems": int(m.n_elems),
            "nl": int(m.nl), "itemsize": itemsize,
            "wet_node_levels": int((nln - uln).clamp_min(0).sum()),
            "wet_elem_levels": int((nle - ule).clamp_min(0).sum()),
            "wet_node_interfaces": int((nln - uln + 1).clamp_min(0).sum())}


def judge(mesh_path: str, cell, seed: int, device, dtype, first: dict,
          last: tuple) -> dict:
    """The gaps and the sizes.  ``first``: the program's snapshot after its
    first call (``steps_per_call`` steps from step 0); ``last``: (step
    index, snapshot before, snapshot after) of the window's last call."""
    c = cell.traffic["steps_per_call"]
    t = time.perf_counter()
    ref = Reference(mesh_path, cell, seed, device, dtype)
    t_setup = time.perf_counter() - t
    r_first = snapshot(*ref.steps(*ref.initial(), 0, c))
    k, before, after = last
    r_after = snapshot(*ref.steps(*ref.load(before), k, c))
    got = gaps(cell, first, r_first, after, r_after)
    sizes = mesh_sizes(ref.model, torch.empty((), dtype=dtype).element_size())
    got.update(setup_s=t_setup, steps_s=time.perf_counter() - t - t_setup,
               sizes=sizes)
    return got


def gaps(cell, first: dict, r_first: dict, after: dict,
         r_after: dict) -> dict:
    """Each number the configuration compares, {name: (gap, field)}: the
    start and the last call over ``compare``."""
    fields = cell.config["compare"]
    return {"start_gap": state_gap(first, r_first, fields),
            "step_gap": state_gap(after, r_after, fields)}
