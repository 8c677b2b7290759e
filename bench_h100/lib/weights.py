"""Seeded weights: one draw on the device for the whole model.

The benchmark makes the weights itself and hands the same values to the
program and to the reference. ``make`` draws one standard normal vector
for every element of the layout (a single call on ``device``, from a
``torch.Generator`` seeded with the run's seed), then scales and shifts
each leaf by its kind, as the published code initialises it, with BN's
affine parameters and running statistics off their identity so that eval
BN is not a no-op:

* conv: kaiming normal (fan_out, ReLU gain); linear: the variance of
  U(+-1/sqrt(fan_in)); bias: N(0, 0.02);
* BN and LayerNorm scale 1 + N(0, 0.1), shift N(0, 0.1); running mean
  N(0, 0.1), running variance |1 + N(0, 0.1)|;
* weight-normed convs: v N(0, 1) (only its direction counts), g the row
  norm of the default conv weight, 1/sqrt(3) times 1 + N(0, 0.1).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from bench_h100.lib import inputs
from bench_h100.reference import jmt

BN_STREAM = 5
Layout = Sequence[Tuple[str, Tuple[int, ...], str]]


def _scale_shift(shape: Tuple[int, ...], kind: str) -> Tuple[float, float]:
    if kind == "conv":
        return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:]))), 0.0
    if kind == "linear":
        return 1.0 / math.sqrt(3.0 * shape[1]), 0.0
    if kind == "bias":
        return 0.02, 0.0
    if kind in ("scale", "var"):
        return 0.1, 1.0
    if kind in ("shift", "mean"):
        return 0.1, 0.0
    if kind == "wn_v":
        return 1.0, 0.0
    if kind == "wn_g":
        return 0.1 / math.sqrt(3.0), 1.0 / math.sqrt(3.0)
    raise ValueError(f"unknown weight kind {kind!r}")


def make(layout: Layout, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights of ``layout`` on ``device``, drawn from ``seed``."""
    sizes = [math.prod(shape) for _, shape, _ in layout]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    pairs = [_scale_shift(shape, kind) for _, shape, kind in layout]
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([p[0] for p in pairs], device=device), counts)
    shift = torch.repeat_interleave(
        torch.tensor([p[1] for p in pairs], device=device), counts)
    flat = flat * scale + shift
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, kind), part in zip(layout, flat.split(sizes)):
        out[name] = (part.abs() if kind == "var" else part).view(shape)
    return out


def build(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed`` on ``device``, BN
    statistics from the data."""
    model = config["model"]
    w = make(jmt.layout(model), seed, device)
    data = inputs.windows(1, config["input"], seed, BN_STREAM, device)
    with jmt.no_tf32(), torch.no_grad():
        jmt.forward_features(jmt.BatchStatsOps(), w, model, data["clips"],
                             data["audio"], block=data["clips"].shape[1])
    return w


def to(w: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in w.items()}


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``weights`` into the model's parameters and buffers of the
    same names (an alias of a tensor is one name; BN's batch counters are
    not in the layout). Raises when a name or shape differs."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    missing = sorted(set(weights) - set(own))
    if missing:
        raise KeyError(f"the program has no tensor {missing[:5]} "
                       f"({len(missing)} in all)")
    with torch.no_grad():
        for name, value in weights.items():
            t = own[name]
            if tuple(t.shape) != tuple(value.shape):
                raise ValueError(f"{name}: the program's shape "
                                 f"{tuple(t.shape)}, the layout's "
                                 f"{tuple(value.shape)}")
            t.copy_(value)
