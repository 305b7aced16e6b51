"""Atmospheric forcing: the file loaders, bulk formulae, the time
interpolation of nodal series, the tidal potential (the port of
``fesom2_tpu/forcing``)."""
