# Frozen copy of fesom2_tpu_torch/ice/icepack/__init__.py, lines 1-17 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Multi-category sea-ice column physics (Icepack-equivalent): the port of
``fesom2_tpu/ice/icepack``.

ncat ice-thickness categories with kcatbound=1 bounds, BL99 vertical
thermodynamics (ktherm=1, conduct 'bubbly' or 'MU71', nilyr/nslyr
layers), linear ITD remapping (kitd=1), Rothrock '75 ice strength
(kstrength=1) fed to the EVP rheology, exponential ridging, CCSM3 or
delta-Eddington shortwave, frazil new-ice formation and lateral melt, and
the optional tracers (CESM ponds, age, first-year area, level ice, floe
size distribution, skeletal-layer biogeochemistry), as arrays over
``[ncat, N]`` and ``[ncat, nlyr, N]``.  Two stages run as hand-written
kernels on the card: the BL99 temperature solve
(``csrc/bl99_temperature.cu``) and the ITD remap with its rebin
(``csrc/itd_remap.cu``).
"""
from .state import IcepackConfig, IcepackState, init_icepack_state
from .driver import icepack_timestep
