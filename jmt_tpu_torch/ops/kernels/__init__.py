"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each kernel module holds the wrapper, a launch counter on it, and a note on
the TPU kernel it replaces. The sources live in ``jmt_tpu_torch/csrc``;
``build.py`` compiles them with nvcc at first use.
"""
