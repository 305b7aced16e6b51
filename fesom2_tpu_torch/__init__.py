"""fesom2_tpu_torch: the PyTorch/CUDA port of fesom2_tpu for one NVIDIA
H100.

It shares the JAX package's jax-free ``fesom2_tpu.config`` and
``fesom2_tpu.constants`` (its only imports from that package) and keeps
its module layout, function names and array layouts; it imports torch and
never jax.
The hot mesh operators run hand-written CUDA kernels (``csrc/``,
``kernels/``) on CUDA tensors and plain torch on CPU tensors.
"""
