"""PyTorch + CUDA port of hagrid_tpu for NVIDIA Hopper (H100).

Module names mirror ``hagrid_tpu`` so each module's counterpart is easy
to find. The package imports ``torch`` and never ``jax``; the one
hand-written kernel (``csrc/sweep.cu``) is built with nvcc at first use.
"""
