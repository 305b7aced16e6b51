"""Atmospheric forcing: bulk formulae and the time interpolation of nodal
series (the port of ``fesom2_tpu/forcing``, without its file readers)."""
