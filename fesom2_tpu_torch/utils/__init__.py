"""Host-side utilities of the port: the model clock, extrapolation into
bathymetry."""
