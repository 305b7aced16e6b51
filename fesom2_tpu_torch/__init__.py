"""fesom2_tpu_torch: the PyTorch/CUDA port of fesom2_tpu for one NVIDIA
H100.

It keeps the JAX package's module layout, function names and array
layouts, and its own copies of that package's ``config`` and ``constants``
modules; it imports torch, never jax and nothing of ``fesom2_tpu``.
The hot mesh operators run hand-written CUDA kernels (``csrc/``,
``kernels/``) on CUDA tensors and plain torch on CPU tensors.
"""
