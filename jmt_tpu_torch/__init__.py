"""PyTorch/CUDA port of jmt_tpu for NVIDIA Hopper.

The serving forward of the joint multimodal transformer (backbones ->
intra-modal fusion -> JMT -> V/A heads) with hand-written CUDA kernels for
the log-mel front end (``ops/kernels/melspec.py``) and the attention core
(``ops/kernels/fused_attention.py``). The package imports torch only;
``jmt_tpu`` is its numerical reference and is used by the tests alone.

Entry points: the trainer, ``python -m jmt_tpu_torch.cli`` (config,
windowed data, ``train/runner.Runner`` with checkpoints, resume and Eval
mode); the server, ``jmt_tpu_torch.serve`` (``InferenceServer`` with one
CUDA graph per bucket on the card, ``from_experiment``, raw audio through
``WavLMFrontend``, ``StreamingSession``, ``measure_latency``, ``python -m
jmt_tpu_torch.serve``); and the WavLM feature extractor, ``python -m
jmt_tpu_torch.data.wavlm_extract``.
"""
from jmt_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
