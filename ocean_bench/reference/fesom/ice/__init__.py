# Frozen copy of fesom2_tpu_torch/ice/__init__.py, lines 1-2 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Sea ice: state, mEVP dynamics, FCT advection, thermodynamics and the
coupling to the ocean (the port of ``fesom2_tpu/ice``)."""
