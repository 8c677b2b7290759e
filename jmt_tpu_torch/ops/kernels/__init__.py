"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each kernel module holds the wrapper, a launch counter on it, and a note on
the TPU kernel it replaces. The sources live in ``jmt_tpu_torch/csrc``;
``build.py`` compiles them with nvcc at first use.
"""
from typing import Dict, Tuple


def _counters() -> Dict[str, Tuple[object, str]]:
    """Each count's (wrapper, attribute): K1 ``log_mel``, K2
    ``fused_attention``, K3 ``inception_module_fused`` (and
    ``inception_pool_in``, its launches with the pool prologue), K4
    ``pool3_1x1``, K5 ``int8_conv``, K6 ``quantize_act``."""
    from jmt_tpu_torch.ops.kernels.fused_attention import fused_attention
    from jmt_tpu_torch.ops.kernels.inception import inception_module_fused
    from jmt_tpu_torch.ops.kernels.int8_conv import int8_conv, quantize_act
    from jmt_tpu_torch.ops.kernels.melspec import log_mel_spec
    from jmt_tpu_torch.ops.kernels.pool1x1 import pool3_1x1
    return {"log_mel": (log_mel_spec, "launches"),
            "fused_attention": (fused_attention, "launches"),
            "inception_module_fused": (inception_module_fused, "launches"),
            "inception_pool_in": (inception_module_fused,
                                  "pool_in_launches"),
            "pool3_1x1": (pool3_1x1, "launches"),
            "int8_conv": (int8_conv, "launches"),
            "quantize_act": (quantize_act, "launches")}


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count (``_counters``' names)."""
    return {k: getattr(w, attr) for k, (w, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for w, attr in _counters().values():
        setattr(w, attr, 0)
