"""PyTorch / CUDA port of ``encdiff_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports ``torch``,
``numpy`` and the standard library only, never ``jax`` and nothing of
``encdiff_tpu``. Its entry points run on ``device="cuda"`` unless the caller
asks for the CPU. The two hand-written CUDA kernels (``csrc/``) are built
with ``nvcc`` at first use and loaded with ``ctypes``
(``nn/kernels/build.py``); on a CPU tensor each wrapper runs its plain
PyTorch version instead.
"""
