# Frozen copy of fesom2_tpu_torch/utils/__init__.py, lines 1-2 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Host-side utilities of the port: the model clock, extrapolation into
bathymetry."""
