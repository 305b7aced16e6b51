# Frozen copy of fesom2_tpu_torch/forcing/__init__.py, lines 1-3 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Atmospheric forcing: the file loaders, bulk formulae, the time
interpolation of nodal series, the tidal potential (the port of
``fesom2_tpu/forcing``)."""
