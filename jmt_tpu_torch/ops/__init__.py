"""Numerical ops: log-mel front end, attention, batch norm, and the
hand-written CUDA kernels under ``ops/kernels``."""
