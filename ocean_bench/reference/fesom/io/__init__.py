# Frozen copy of fesom2_tpu_torch/io/__init__.py, lines 1-1 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""File input of the port (host numpy)."""
