# Frozen copy of fesom2_tpu_torch/toy/__init__.py, lines 1-0 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
