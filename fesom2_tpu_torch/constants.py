"""Physical and numerical constants of the model.

Values mirror the reference FESOM2 parameter module (``src/oce_modules.F90:10-21``,
module ``o_PARAM``) so that trajectories can be validated against the Fortran
reference.  SI units throughout.

The port's own copy of ``fesom2_tpu/constants.py``, without its
``float_dtype`` (which asks jax); ``tests/test_torch_config.py`` holds the
two value for value.
"""

pi = 3.14159265358979
rad = pi / 180.0            # degrees -> radians
density_0 = 1030.0          # reference density [kg/m^3]
density_0_r = 1.0 / density_0
g = 9.81                    # gravity [m/s^2]
r_earth = 6367500.0         # Earth radius [m]
omega = 2.0 * pi / (3600.0 * 24.0)  # Earth angular velocity [1/s]
vcpw = 4.2e6                # volumetric heat capacity of water [J/m^3/K]
inv_vcpw = 1.0 / vcpw
small = 1.0e-8

# Sea-ice constants (reference: src/ice_modules.F90 / ice_EVP.F90)
rhoice = 910.0              # ice density [kg/m^3]
rhosno = 290.0              # snow density [kg/m^3]
rhowat = 1025.0             # water density used by the ice model [kg/m^3]
cl = 3.02e8                 # volumetric latent heat of ice fusion [J/m^3]

SECONDS_PER_DAY = 86400.0

