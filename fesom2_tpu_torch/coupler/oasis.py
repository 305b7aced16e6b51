"""Atmosphere coupler interface (OASIS3-MCT equivalent).

Reference: ``src/cpl_driver.F90`` — field sets :26-37,:382-426, send-side
time averaging :491-559; ``src/gen_forcing_couple.F90`` — recv mapping onto
forcing arrays :99-170 and conservative flux correction ``force_flux_consv``
:356-468.

The port of ``fesom2_tpu/coupler/oasis.py``.  The exchange backend is a
pluggable transport (``InMemoryTransport`` in-process, ``transport.
OasisEndpoint`` / ``SocketTransport`` over a socket).  Where the JAX
driver copies every send field to the host every step, here:

- ``CplDriver.collect`` keeps its accumulators on the state's device in
  the state's dtype;
- ``send`` moves the time means to the host once a coupling event (one
  copy of the stacked fields);
- ``recv`` builds ``CoupledAtmFluxes`` and the stresses on the mesh's
  device in the mesh's dtype (one copy of the stacked fields);
- ``force_flux_consv`` is one stacked device reduction and elementwise
  selects, with no host read.

Their consumer is ``ice.step.ice_timestep_cpl``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..mesh import MeshTables
from ..ice.thermo_cpl import CoupledAtmFluxes

tmelt = 273.15

# ref cpl_driver.F90:382-398
SEND_FIELDS_OIFS = ["sst_feom", "sie_feom", "snt_feom", "ist_feom",
                    "sia_feom"]
SEND_FIELDS_ECHAM = ["sst_feom", "sit_feom", "sie_feom", "snt_feom"]
# ref cpl_driver.F90:401-426
RECV_FIELDS_ECHAM = ["taux_oce", "tauy_oce", "taux_ico", "tauy_ico",
                     "prec_oce", "snow_oce", "evap_oce", "subl_oce",
                     "heat_oce", "heat_ico", "heat_swo", "hydr_oce"]
RECV_FIELDS_OIFS = RECV_FIELDS_ECHAM + ["enth_oce"]


class InMemoryTransport:
    """Test double for the OASIS exchange: a named-field mailbox."""

    def __init__(self):
        self._box: Dict[str, np.ndarray] = {}

    def put(self, name: str, field):
        self._box[name] = np.asarray(field)

    def get(self, name: str) -> Optional[np.ndarray]:
        return self._box.get(name)


class CplDriver:
    """Send/receive driver with the reference's averaging protocol:
    send fields are accumulated every step and their time mean is shipped
    at coupling events (ref cpl_oasis3mct_send ``cpl_driver.F90:491-559``,
    o2a_call_count)."""

    def __init__(self, mesh: MeshTables, transport, oifs: bool = False):
        self.mesh = mesh
        self.transport = transport
        self.oifs = oifs
        self.send_names = SEND_FIELDS_OIFS if oifs else SEND_FIELDS_ECHAM
        self.recv_names = RECV_FIELDS_OIFS if oifs else RECV_FIELDS_ECHAM
        self._acc: Dict[str, torch.Tensor] = {}
        self._count = 0

    # -- send side -----------------------------------------------------------
    def collect(self, state, ice, ice_temp=None, ice_alb=None):
        """Accumulate this step's send fields on their device (ref
        update_atm_forcing send block, gen_forcing_couple.F90:58-95)."""
        sst = state.tr[0, 0]
        if self.oifs:
            fields = {"sst_feom": sst + tmelt,
                      "sie_feom": ice.a_ice,
                      "snt_feom": ice.m_snow,
                      "ist_feom": (ice_temp if ice_temp is not None
                                   else ice.t_skin + tmelt),
                      "sia_feom": (ice_alb if ice_alb is not None
                                   else torch.zeros_like(sst))}
        else:
            fields = {"sst_feom": sst,
                      "sit_feom": ice.m_ice,
                      "sie_feom": ice.a_ice,
                      "snt_feom": ice.m_snow}
        for k, v in fields.items():
            self._acc[k] = self._acc.get(k, 0.0) + v
        self._count += 1

    def send(self):
        """Ship the time-averaged send fields (one copy to the host) and
        reset the accumulator."""
        if self._count == 0:
            return
        names = list(self._acc)
        means = (torch.stack([self._acc[k] for k in names])
                 / self._count).cpu().numpy()
        for k, v in zip(names, means):
            self.transport.put(k, v)
        self._acc = {}
        self._count = 0

    # -- recv side -----------------------------------------------------------
    def recv(self):
        """Fetch the atmosphere fields and map them onto the model's
        forcing slots (ref gen_forcing_couple.F90:99-170), on the mesh's
        device in its dtype.  Returns (CoupledAtmFluxes, stresses dict) or
        None if the transport has no data yet."""
        got = {n: self.transport.get(n) for n in self.recv_names}
        if any(v is None for v in got.values()):
            return None
        ref = self.mesh.area
        rows = torch.from_numpy(np.stack([np.asarray(got[n])
                                          for n in self.recv_names]))
        rows = rows.to(device=ref.device, dtype=ref.dtype)
        t = dict(zip(self.recv_names, rows.unbind(0)))
        atm = CoupledAtmFluxes(
            oce_heat_flux=t["heat_oce"], ice_heat_flux=t["heat_ico"],
            shortwave=t["heat_swo"], evap_no_ifrac=t["evap_oce"],
            sublimation=t["subl_oce"], prec_rain=t["prec_oce"],
            prec_snow=t["snow_oce"], runoff=t["hydr_oce"])
        stresses = {"stress_atmoce_x": t["taux_oce"],
                    "stress_atmoce_y": t["tauy_oce"],
                    "stress_atmice_x": t["taux_ico"],
                    "stress_atmice_y": t["tauy_ico"]}
        if self.oifs:
            stresses["enthalpyoffuse"] = t["enth_oce"]
        return atm, stresses


def force_flux_consv(field, mask, atm_net, mesh: MeshTables,
                     hemisphere: int = 0):
    """Conservative flux correction (ref force_flux_consv
    gen_forcing_couple.F90:356-468): redistribute the residual between the
    atmosphere-side net flux and the ocean-grid integral, weighted by
    |field| (falling back to uniform weights), restricted to a hemisphere
    (0=global, 1=NH, 2=SH).  Skipped entirely in OIFS builds, which rely on
    OASIS conservative remapping (ref :384-386).  The three integrals are
    one reduction of the stacked products."""
    area = mesh.area[0]
    lat = mesh.geo_coords[:, 1]
    mask = torch.as_tensor(mask, dtype=field.dtype, device=field.device)
    if hemisphere == 1:
        rmask = torch.where(lat >= 0, mask, 0.0)
    elif hemisphere == 2:
        rmask = torch.where(lat < 0, mask, 0.0)
    else:
        rmask = mask
    w_area = rmask * area
    oce_net, absint, eff_vol = torch.stack(
        [field * w_area, field.abs() * w_area, w_area]).sum(-1)
    residual = atm_net - oce_net
    uniform = torch.ones_like(field) / torch.where(eff_vol > 0, eff_vol, 1.0)
    weighted = field.abs() / torch.where(absint > 1e-10, absint, 1.0)
    weight = torch.where(absint > 1e-10, weighted, uniform)
    weight = torch.where(rmask > 1e-10, weight, 0.0)
    return field + weight * residual
