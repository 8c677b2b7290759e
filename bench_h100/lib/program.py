"""The system under test: the port's model, server and train step.

Everything the benchmark takes from ``jmt_tpu_torch`` goes through here:
``JMTModel`` with the configuration's constructor arguments, the seeded
weights loaded into it, ``serve.InferenceServer`` (one CUDA graph for the
cell's bucket; static int8 calibrated first by
``serve.calibration_scales``), and ``train.loops`` for the train step.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_h100.lib import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def build_model(config: Dict, w: Dict[str, torch.Tensor], device
                ) -> torch.nn.Module:
    """The configuration's model on ``device``, holding a copy of the
    weights ``w``."""
    from jmt_tpu_torch.models.jmt_model import JMTModel
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["model"].items()}
    with torch.device(device):
        model = JMTModel(**kw, dtype=DTYPES[config["compute_dtype"]])
    weights.load_into(model, w)
    return model


def build_server(config: Dict, bucket: int, w: Dict[str, torch.Tensor],
                 device, calibration: Optional[Dict] = None, int8=None):
    """The server of one bucket. ``int8`` (default: the configuration's):
    False, True (dynamic) or "static", calibrated on ``calibration`` (a
    request's host arrays)."""
    from jmt_tpu_torch.serve import InferenceServer, calibration_scales
    model = build_model(config, w, device)
    int8 = config["int8"] if int8 is None else int8
    scales = None
    if int8 == "static":
        scales = calibration_scales(model, calibration["clips"],
                                    calibration["audio"],
                                    calibration["wavlm"], device=device)
    inp = config["input"]
    return InferenceServer(model, seq=inp["seq"], buckets=(bucket,),
                           img_size=inp["size"],
                           audio_samples=inp["audio_samples"],
                           device=device, int8=int8, int8_scales=scales)


def capture_seconds(server) -> float:
    """Warm-up and capture seconds of the server's graphs (0 on the
    CPU, which captures none)."""
    return sum(g.seconds for g in server.graphs.values())


def build_train(config: Dict, optimizer: Dict, w: Dict[str, torch.Tensor],
                device):
    """(state, step): the trainer's state (every backbone frozen, SGD
    over the rest) and ``train.loops.make_train_step``'s step."""
    from jmt_tpu_torch.core.config import Config, ModelParams, OptimParams
    from jmt_tpu_torch.train import loops
    model = build_model(config, w, device)
    m = config["model"]
    cfg = Config(model_params=ModelParams(
        l_vision_backbones=list(m["vision_backbones"]),
        l_audio_backbones=list(m["audio_backbones"]),
        intra_modal_fusion=m["intra_modal_fusion"],
        opt=OptimParams(name_optimizer="sgd", **optimizer)))
    state = loops.init_state(model, cfg, None, device=device)
    group = state.optimizer.param_groups[0]
    for k, v in optimizer.items():
        if group[k] != v:
            raise ValueError(f"the program's optimizer has {k}="
                             f"{group[k]!r}, the mix {v!r}")
    return state, loops.make_train_step(model, device=device)


def trainable_tensors(state) -> Dict[str, torch.Tensor]:
    params = dict(state.model.named_parameters())
    return {n: params[n] for n in state.trainable}


def momentum_buffers(state) -> Dict[str, torch.Tensor]:
    """Each trainable tensor's SGD momentum buffer (after the first step:
    the gradient as the optimizer got it, with its weight decay); a
    tensor the optimizer skipped has none."""
    out = {}
    for n, p in trainable_tensors(state).items():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[n] = buf.detach().clone()
    return out

