# Frozen copy of fesom2_tpu_torch/parallel/__init__.py, lines 1-1 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Host-side decomposition of the mesh (numpy)."""
