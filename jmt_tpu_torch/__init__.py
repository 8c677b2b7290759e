"""PyTorch/CUDA port of jmt_tpu for NVIDIA Hopper.

The serving forward of the joint multimodal transformer (backbones ->
intra-modal fusion -> JMT -> V/A heads) with hand-written CUDA kernels for
the log-mel front end (``ops/kernels/melspec.py``) and the attention core
(``ops/kernels/fused_attention.py``). The package imports torch only;
``jmt_tpu`` is its numerical reference and is used by the tests alone.

Entry point: ``jmt_tpu_torch.serve.InferenceServer``.
"""
from jmt_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
