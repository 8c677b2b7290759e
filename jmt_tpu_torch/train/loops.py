"""The train and eval steps, and the device preprocessing they share.

Counterpart of ``jmt_tpu/train/loops.py``. One step takes raw uint8 clips,
raw audio, wavLM features and labels, and runs the whole pipeline on the
device: the colour augmentation (train step; or with
``use_more_vision_data_augm`` the heavy per-frame vision augmentation in
its place), the log-mel front end (one launch of kernel K1 for all B*S
wavs on the card; with ``use_more_audio_data_augm`` the train step's
heavy audio augmentation in its place, mel magnitudes without K1), the backbones over the
flattened (B*S) clips, the fusion, the CCC loss of V plus that of A, the
backward and the optimizer step. Parameters stay fp32; the model computes
in its ``dtype`` (bf16 on the card).

Usage::

    state = init_state(model, cfg, torch.Generator().manual_seed(0))
    train_step = make_train_step(model)
    loss, v, a = train_step(state, arrays)      # arrays: device_batch(...)
    eval_step = make_eval_step(model)
    v, a = eval_step(state, arrays)             # (B, S) each
    maxes = make_calibration_step(model)(state, arrays)   # int8 inference:
    scales = quant.act_scales_from_maxes(maxes)
    v, a = make_eval_step(model, int8=True, act_scales=scales)(state, arrays)

The entry points run on the card; ``device="cpu"`` runs the plain PyTorch
path on the CPU, and with no card present the default raises.

Under a process group (``parallel/mesh``: one rank per card, each with
its row block of the global batch) the train step computes what JAX's
does on the global batch: BN in train mode takes the global batch's
statistics (``ops/norm.global_batch_statistics``); every rank gathers
the outputs, labels and row weights (a differentiable all-gather) and
computes the CCC loss over the whole batch (a CCC does not split into a
mean of per-rank CCCs); the augmentation parameters are drawn for the
global batch from the step's generator and each rank takes its rows;
the ranks' gradients are averaged before the optimizer step (the
gather's backward sums over ranks, so each rank's gradient holds
``world`` times its share).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from jmt_tpu_torch.data.transforms import (VisionAugment,
                                           more_vision_augment,
                                           preprocess_clips,
                                           sample_color_factors,
                                           sample_vision_augment)
from jmt_tpu_torch.device import resolve_device
from jmt_tpu_torch.ops import quant
from jmt_tpu_torch.ops.audio_augment import (AudioAugment,
                                             more_audio_augment,
                                             sample_audio_augment)
from jmt_tpu_torch.ops.ccc import ccc_loss
from jmt_tpu_torch.ops.mel import log_mel
from jmt_tpu_torch.ops.norm import global_batch_statistics
from jmt_tpu_torch.parallel import mesh
from jmt_tpu_torch.train.optim import build_optimizer
from jmt_tpu_torch.train.state import (TrainState, frozen_prefixes,
                                       partition_params)

Arrays = Dict[str, Any]


def device_batch(batch) -> Arrays:
    """A host batch (attributes clips, audio, labels_v, labels_a and
    optionally wavlm) -> the arrays dict of the steps."""
    out = {"clips": batch.clips,           # uint8 (B, S, 8, 112, 112, 3)
           "audio": batch.audio,           # f32 (B, S, 45599)
           "labels_v": batch.labels_v,     # f32 (B, S)
           "labels_a": batch.labels_a}
    if getattr(batch, "wavlm", None) is not None:
        out["wavlm"] = batch.wavlm         # f32 (B, S, 768)
    return out


def _on(arrays: Arrays, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(x).to(device) for k, x in arrays.items()}


def preprocess(model, arrays: Dict[str, torch.Tensor],
               color_factors: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
               more_vision_augm: bool = False, more_audio_augm: bool = False,
               vision_augment: Optional[VisionAugment] = None,
               audio_augment: Optional[AudioAugment] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """arrays: ``clips`` uint8 (B,S,8,H,W,3), ``audio`` f32 (B,S,L).

    Returns ``(spec, clips)``: the normalized log-mel (B,S,64,1+L//441) when
    the model has the ResNet18 audio branch (one log-mel kernel launch for
    all B*S wavs on the card), and the normalized clips (B,S,8,H,W,3); each
    in the model's compute dtype, or None when the model does not use it.
    ``color_factors``: the (B*S,) brightness and contrast factors of the
    train step's colour augmentation (``sample_color_factors``); None for
    the eval forward. The heavy augmentations of the train step, each in
    the place of its plain counterpart as in JAX: ``more_vision_augm``
    (``data/transforms.more_vision_augment``, per frame; the colour
    factors are not used) and ``more_audio_augm``
    (``ops/audio_augment.more_audio_augment``: spec (B,S,64,128) mel
    magnitudes, no K1), with the given parameters, else drawn from
    ``generator`` (vision first).
    """
    out_dtype = model.dtype or torch.float32
    clips = spec = None
    if len(model.vision_backbones) > 0:
        c = arrays["clips"]
        flat = c.reshape(-1, *c.shape[2:])
        if more_vision_augm:
            if vision_augment is None:
                vision_augment = sample_vision_augment(
                    generator, flat.shape[0] * flat.shape[1],
                    device=c.device)
            clips = more_vision_augment(flat, vision_augment)
        elif color_factors is None:
            clips = preprocess_clips(c)
        else:
            clips = preprocess_clips(flat, *color_factors, augment=True)
        clips = clips.reshape(c.shape).to(out_dtype)
    if "ResNet18" in model.audio_backbones:
        a = arrays["audio"]
        if more_audio_augm:
            if audio_augment is None:
                audio_augment = sample_audio_augment(
                    generator, a.shape[0] * a.shape[1], device=a.device)
            mel = more_audio_augment(a.reshape(-1, a.shape[-1]),
                                     audio_augment)
            spec = mel.reshape(*a.shape[:2], *mel.shape[1:])
        else:
            spec = log_mel(a, batch_dims=2)
        spec = spec.to(out_dtype)
    return spec, clips


def _check_state(model, state: TrainState) -> None:
    if state.model is not model:
        raise ValueError("the step was made for another model than the "
                         "state's")


def _global_draws(model, b: int, s: int, frames: int, generator, dev,
                  more_vision_augm: bool, more_audio_augm: bool,
                  color_factors, vision_augment, audio_augment) -> tuple:
    """(color_factors, vision_augment, audio_augment): those not given
    drawn from ``generator`` for the global batch of ``world * b`` rows,
    in the order that one process draws them, and cut to this rank's
    rows."""
    rank, world = mesh.proc_info()

    def mine(x, per_row):
        return x[rank * b * per_row:(rank + 1) * b * per_row]

    if len(model.vision_backbones) > 0:
        if more_vision_augm and vision_augment is None:
            va = sample_vision_augment(generator, world * b * s * frames,
                                       device=dev)
            vision_augment = VisionAugment(*(mine(t, s * frames)
                                             for t in va))
        elif not more_vision_augm and color_factors is None:
            cf = sample_color_factors(generator, world * b * s, device=dev)
            color_factors = tuple(mine(t, s) for t in cf)
    if ("ResNet18" in model.audio_backbones and more_audio_augm
            and audio_augment is None):
        aa = sample_audio_augment(generator, world * b * s, device=dev)
        audio_augment = AudioAugment(*(mine(t, s) for t in aa))
    return color_factors, vision_augment, audio_augment


def make_train_step(model, more_vision_augm: bool = False,
                    more_audio_augm: bool = False, device=None) -> Callable:
    """Returns ``train_step(state, arrays, generator=None,
    color_factors=None, vision_augment=None, audio_augment=None) -> (loss,
    vouts, aouts)``.

    One SGD step in place on ``state``: augmented preprocessing (the
    colour augmentation, or the heavy ones of ``more_vision_augm`` /
    ``more_audio_augm``, ``preprocess``),
    the forward in train mode (``JMTModel.train``: frozen backbones stay
    in eval mode), ccc_loss(V) + ccc_loss(A) on the flattened (B*S)
    outputs with ``arrays["row_weight"]`` (B,) masking padding rows,
    backward, ``state.optimizer.step()``. The colour factors and the heavy
    augmentations' parameters are drawn from ``generator`` (torch's
    default one when None) unless given, in that order.
    The step runs inside the ``torch.profiler`` range ``train_step``,
    divided into four phases, one after another:
    ``train_step.prepare`` (the state check, the arrays on the device,
    the draws, ``model.train()``), ``train_step.forward`` (preprocessing,
    forward and loss), ``train_step.backward`` (``zero_grad`` and the
    backward) and ``train_step.optimizer``. The backward's kernels are
    launched from autograd's own thread, but inside the main thread's
    ``train_step.backward`` interval, so each phase owns the device's
    idle time within its interval.

    Under a process group of more than one rank, ``arrays`` are this
    rank's rows of the global batch (the same count on every rank), the
    step computes JAX's global step (the module docstring), and the
    returned ``loss`` is the global one, ``vouts``/``aouts`` this rank's
    rows. Give every rank the same ``generator`` (the global batch's
    draws are cut to the rank's rows).
    """
    dev = resolve_device(device)
    model.to(dev)

    def train_step(state: TrainState, arrays: Arrays,
                   generator: Optional[torch.Generator] = None,
                   color_factors=None, vision_augment=None,
                   audio_augment=None):
        with record_function("train_step"):
            with record_function("train_step.prepare"):
                _check_state(model, state)
                x = _on(arrays, dev)
                b, s = x["labels_v"].shape[:2]
                ranks = mesh.proc_info()[1]
                if ranks > 1:
                    color_factors, vision_augment, audio_augment = \
                        _global_draws(model, b, s, x["clips"].shape[2],
                                      generator, dev, more_vision_augm,
                                      more_audio_augm, color_factors,
                                      vision_augment, audio_augment)
                elif (color_factors is None and not more_vision_augm
                        and len(model.vision_backbones) > 0):
                    color_factors = sample_color_factors(generator, b * s,
                                                         device=dev)
                model.train()
            with global_batch_statistics(ranks > 1):
                with record_function("train_step.forward"):
                    spec, clips = preprocess(model, x, color_factors,
                                             more_vision_augm,
                                             more_audio_augm, vision_augment,
                                             audio_augment, generator)
                    vouts, aouts = model(spec, clips, x.get("wavlm"))
                    rw = x.get("row_weight")
                    w = None if rw is None else rw[:, None].to(
                        vouts.dtype).expand(vouts.shape)
                    g = mesh.all_gather_rows
                    wg = None if w is None else g(w).reshape(-1)
                    loss = (ccc_loss(g(vouts).reshape(-1),
                                     g(x["labels_v"]).reshape(-1), weight=wg)
                            + ccc_loss(g(aouts).reshape(-1),
                                       g(x["labels_a"]).reshape(-1),
                                       weight=wg))
                with record_function("train_step.backward"):
                    state.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
            with record_function("train_step.optimizer"):
                if ranks > 1:
                    mesh.average_gradients(
                        p for grp in state.optimizer.param_groups
                        for p in grp["params"])
                state.optimizer.step()
            return loss.detach(), vouts.detach(), aouts.detach()

    return train_step


def eval_forward(model, arrays: Dict[str, torch.Tensor], int8=False,
                 act_scales=None, int8_weights=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward of arrays already on the model's device: eval mode
    (running-statistics BN, no dropout), no augmentation,
    ``torch.inference_mode``. The eval step's and the server's. ``int8``:
    eligible backbone convs in int8 (``ops/quant.int8_inference``),
    static with ``act_scales``, their weights prepared per call or taken
    from ``int8_weights`` (``quant.collect_int8_weights``)."""
    if model.training:  # a train step left it in train mode
        model.eval()
    with torch.inference_mode(), quant.int8_inference(
            bool(int8), act_scales=act_scales, weights=int8_weights):
        spec, clips = preprocess(model, arrays)
        return model(spec, clips, arrays.get("wavlm"))


def calibration_forward(model, arrays: Dict[str, torch.Tensor]
                        ) -> torch.Tensor:
    """One eval forward of arrays on the model's device that records each
    eligible conv's max |x| (``ops/quant.int8_calibration``): an f32
    vector on the host, execution order, copied once."""
    if model.training:
        model.eval()
    coll: list = []
    with torch.inference_mode(), quant.int8_calibration(coll):
        spec, clips = preprocess(model, arrays)
        model(spec, clips, arrays.get("wavlm"))
    return quant.stack_maxes(coll)


def make_calibration_step(model, device=None) -> Callable:
    """Returns ``calib_step(state, arrays) -> maxes``: the per-eligible-conv
    activation max |x| (f32, execution order) of the eval forward. Feed
    it to ``ops/quant.act_scales_from_maxes`` and the scales to
    ``make_eval_step(int8=True, act_scales=...)``."""
    dev = resolve_device(device)
    model.to(dev)

    def calib_step(state: TrainState, arrays: Arrays) -> torch.Tensor:
        _check_state(model, state)
        return calibration_forward(model, _on(arrays, dev))

    return calib_step


def make_eval_step(model, device=None, int8=False,
                   act_scales=None) -> Callable:
    """Returns ``eval_step(state, arrays) -> (vouts, aouts)``, each (B, S):
    ``eval_forward`` on the arrays moved to the device. ``int8=True``:
    eligible backbone convs in int8, with dynamic activation scales, or
    static ``act_scales`` (``make_calibration_step``). Inference only."""
    dev = resolve_device(device)
    model.to(dev)

    def eval_step(state: TrainState, arrays: Arrays):
        _check_state(model, state)
        return eval_forward(model, _on(arrays, dev), int8, act_scales)

    return eval_step


def init_state(model, cfg, generator: Optional[torch.Generator] = None,
               variables_hook: Optional[Callable] = None,
               device=None) -> TrainState:
    """Initialize the weights from ``generator`` (``init_parameters``, on
    the CPU, so every device starts from the same weights), run
    ``variables_hook(model)`` (the point to load pretrained weights),
    move the model to the device, freeze the backbones that
    ``cfg.model_params`` freezes and build its optimizer over the
    trainable parameters."""
    from jmt_tpu_torch.models.common import init_parameters
    dev = resolve_device(device)
    want = cfg.model_params.finetune()
    if set(getattr(model, "finetune", want)) != set(want):
        raise ValueError(f"the model finetunes {model.finetune}, the "
                         f"config's freeze flags say {want}")
    if generator is not None:
        init_parameters(model.cpu(), generator)
    if variables_hook is not None:
        variables_hook(model)
    model.to(dev)
    trainable, frozen = partition_params(model, frozen_prefixes(cfg))
    params = dict(model.named_parameters())
    optimizer = build_optimizer(cfg.model_params.opt,
                                [params[n] for n in trainable])
    return TrainState(model=model, optimizer=optimizer, trainable=trainable,
                      frozen=frozen, epoch=0)
