"""Operations and bytes of one unit of work, from shapes, and the peaks.

The reference (``bench_h100/reference``) runs on the meta device under
``CountOps``, which records every conv, linear and attention product it
computes at the cell's shapes; nothing is timed or allocated. A
``Census`` sums them:

* operations: 2 per multiply-add of the convs, the linears and the two
  attention products (the log-mel, BN, pools and elementwise work are
  left out); the I3D stem is counted as the served model computes it,
  the folded 7 x 5 x 5 conv and its border terms on the 112 px clip;
* the least time of a forward on the card: each operation at its peak,
  the int8 configuration's eligible convs (contraction >= 64, outside
  the inception modules) at the s8 peak and the rest at the bf16 peak;
* K3, one inception module a launch: its convs' operations, and bytes
  read and written once (the module input and output and the weights in
  bf16, the biases in f32); its least time the larger of operations over
  the bf16 peak and bytes over HBM bandwidth, summed over the modules;
* K5, one eligible conv a launch: the int8 input and weights read once,
  the bf16 output written once, against the s8 peak, summed;
* a frozen-backbone train step: the forward, and twice the fusion's
  operations for its backward (the backbones get none).

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from bench_h100.reference import jmt

BF16_PEAK = 989e12      # FLOP/s, dense tensor cores
S8_PEAK = 1979e12       # OP/s, dense tensor cores
HBM_BYTES_PER_S = 3.35e12


class CountOps(jmt.Ops):
    """Records the operations and operand sizes of every conv, linear and
    attention product (on meta tensors)."""

    def __init__(self):
        super().__init__()
        self.convs: List[dict] = []
        self.modules: List[dict] = []
        self.other_flops = 0.0
        self._module_flops = 0.0

    def conv(self, x, w, stride=1, pads=None, dilation=1):
        out = super().conv(x, w, stride, pads, dilation)
        k = math.prod(w.shape[1:])
        flops = 2.0 * out.numel() * k
        inside = "inception" in self.regions
        if inside:
            self._module_flops += flops
        self.convs.append(dict(
            flops=flops, x=x.numel(), w=w.numel(), out=out.numel(),
            int8=k >= jmt.MIN_CONTRACTION and not inside))
        return out

    def linear(self, x, w, b=None):
        self.other_flops += 2.0 * (x.numel() // x.shape[-1]) * w.numel()
        return super().linear(x, w, b)

    def attend(self, q, k, v):
        b, lq, h, hd = q.shape
        self.other_flops += 4.0 * b * h * lq * k.shape[1] * hd
        return super().attend(q, k, v)

    def note(self, kind, x, out, weights):
        w = sum(t.numel() for t in weights if t.ndim > 1)
        bias = sum(t.numel() for t in weights if t.ndim == 1)
        self.modules.append(dict(flops=self._module_flops, x=x.numel(),
                                 out=out.numel(), w=w, bias=bias))
        self._module_flops = 0.0


@dataclasses.dataclass
class Census:
    """The counts of one unit: a request of ``windows`` windows or a
    train step of that many rows."""
    conv_flops: float
    int8_flops: float
    other_flops: float
    k3_bound_s: float
    k5_bound_s: float
    k3_flops: float

    @property
    def flops(self) -> float:
        return self.conv_flops + self.other_flops

    def least_time_s(self, int8: bool) -> float:
        """The forward's least time on the card at the published peaks."""
        if not int8:
            return self.flops / BF16_PEAK
        return (self.int8_flops / S8_PEAK
                + (self.flops - self.int8_flops) / BF16_PEAK)

    def train_least_time_s(self) -> float:
        """A frozen-backbone step: the forward and the fusion's backward
        (twice its forward), at the bf16 peak."""
        return (self.flops + 2.0 * self.other_flops) / BF16_PEAK


def census(config: dict, windows: int) -> Census:
    """Run the reference at the shapes of ``windows`` windows of the
    configuration on the meta device and sum what it computes."""
    model, inp = config["model"], config["input"]
    ops = CountOps()
    meta = torch.device("meta")
    w = {name: torch.empty(shape, device=meta)
         for name, shape, _ in jmt.layout(model)}
    seq = inp["seq"]
    clips = torch.empty(windows, seq, inp["frames"], inp["size"],
                        inp["size"], 3, dtype=torch.uint8, device=meta)
    audio = torch.empty(windows, seq, inp["audio_samples"], device=meta)
    wavlm = torch.empty(windows, seq, inp["wavlm_dim"], device=meta)
    jmt.forward(ops, w, model, clips, audio, wavlm,
                fold=model["i3d_input_size"] == 2 * inp["size"])
    k3 = sum(max(m["flops"] / BF16_PEAK,
                 (2.0 * (m["x"] + m["out"] + m["w"]) + 4.0 * m["bias"])
                 / HBM_BYTES_PER_S) for m in ops.modules)
    k5 = sum(max(c["flops"] / S8_PEAK,
                 (c["x"] + c["w"] + 2.0 * c["out"]) / HBM_BYTES_PER_S)
             for c in ops.convs if c["int8"])
    return Census(conv_flops=sum(c["flops"] for c in ops.convs),
                  int8_flops=sum(c["flops"] for c in ops.convs
                                 if c["int8"]),
                  other_flops=ops.other_flops, k3_bound_s=k3,
                  k5_bound_s=k5,
                  k3_flops=sum(m["flops"] for m in ops.modules))
