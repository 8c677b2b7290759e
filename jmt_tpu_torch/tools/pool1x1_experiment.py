"""Kernel K4 (``ops/kernels/pool1x1.py``) on the card: the counterpart of
the TPU experiment ``tools/pallas_pool1x1_experiment.py``.

    python -m jmt_tpu_torch.tools.pool1x1_experiment check        # K4 vs plain
    python -m jmt_tpu_torch.tools.pool1x1_experiment time         # 3 shapes
    python -m jmt_tpu_torch.tools.pool1x1_experiment time2        # 3 more
    python -m jmt_tpu_torch.tools.pool1x1_experiment chain [cudnn]

``check``: K4 against its plain version at the TPU tool's two check
shapes, N(0, 1) inputs, f32 (TF32 off, within 1e-5 of max |plain|) and
bf16 (1e-2). ``time`` / ``time2``: the TPU tool's six timed shapes in bf16
at 128 clips: K4, its plain version and the library yardstick
(``max_pool_same`` + a 1x1 ``F.conv3d``, cuDNN, channels-last), CUDA-event
ms, the bound and the error. ``chain``: Mixed_4b..4f at (128, 8, 14, 14,
480) in bf16, the port's unfused modules as the TPU tool builds them,
b3 through K4 where C is 480 or 512 (``cudnn``: every b3 through
``max_pool_same`` and cuDNN). Each record prints as one JSON line. Needs a
CUDA card; shapes are (N, T, H, W, C) as in the TPU tool.
"""
from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import cast, init_parameters
from jmt_tpu_torch.models.i3d import (I3D_STAGES, InceptionModule,
                                      module_channels)
from jmt_tpu_torch.ops.conv import max_pool_same
from jmt_tpu_torch.ops.kernels.pool1x1 import pool3_1x1
from jmt_tpu_torch.ops.pool1x1 import pool3_1x1_plain

BF16_PEAK_FLOPS = 989e12    # H100 SXM bf16 dense tensor peak
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
CHANNELS_LAST = torch.channels_last_3d

CHECK_SHAPES = (((2, 4, 6, 6, 16), 8), ((1, 8, 14, 14, 32), 16))
TIME_SHAPES = {
    "time": (((128, 8, 14, 14, 512), 64), ((128, 4, 7, 7, 832), 128),
             ((128, 8, 28, 28, 256), 64)),
    "time2": (((128, 8, 14, 14, 480), 64), ((128, 8, 14, 14, 528), 128),
              ((128, 8, 28, 28, 192), 32))}
CHAIN_INPUT = (128, 8, 14, 14, 480)
CHAIN_K4_CHANNELS = (480, 512)   # the b3 inputs the TPU tool sent to K4
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(shape: Sequence[int], co: int, dtype: torch.dtype,
           gen: torch.Generator, k_scale: float):
    """x ~ N(0, 1) (N, T, H, W, C) as (N, C, T, H, W) channels-last, and
    k ~ N(0, k_scale^2) (C, co), on the card in ``dtype``."""
    x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    k = k_scale * torch.randn(shape[-1], co, device="cuda", generator=gen)
    return x.permute(0, 4, 1, 2, 3), k.to(dtype)


def compare(x: torch.Tensor, k: torch.Tensor) -> dict:
    """K4 against its plain version; raises beyond TOL of max |plain|."""
    got = pool3_1x1(x, k)
    want = pool3_1x1_plain(x, k)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    if not (got.shape == want.shape and got.is_contiguous(
            memory_format=CHANNELS_LAST) and rel <= TOL[x.dtype]):
        raise AssertionError(f"pool3_1x1 kernel {tuple(x.shape)} {x.dtype}: "
                             f"relative err {rel} (tol {TOL[x.dtype]})")
    return {"max_abs_err": err, "rel_err": rel}


def check(gen: torch.Generator) -> list:
    """The TPU tool's check shapes, f32 with TF32 off and bf16."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return [{"mode": "check", "shape": list(shape), "co": co,
                 "dtype": str(dtype).split(".")[-1],
                 **compare(*inputs(shape, co, dtype, gen, 0.1))}
                for dtype in (torch.float32, torch.bfloat16)
                for shape, co in CHECK_SHAPES]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def time_case(shape: Sequence[int], co: int, gen: torch.Generator,
              iters: int = 10) -> dict:
    """bf16 at one timed shape: K4, plain and library ms, the bound (x in,
    out, k; 2 N T H W C Co operations at the bf16 peak) and the error."""
    x, k = inputs(shape, co, torch.bfloat16, gen, 0.05)
    w = k.t().reshape(co, -1, 1, 1, 1).contiguous()

    def library():
        return F.conv3d(max_pool_same(x, (3, 3, 3), (1, 1, 1)), w)

    rows = x.numel() // x.shape[1]
    n_bytes = (x.numel() + rows * co + k.numel()) * x.element_size()
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * x.shape[1] * co / BF16_PEAK_FLOPS * 1e3
    rec = {"mode": "time", "shape": list(shape), "co": co, "dtype": "bfloat16",
           **compare(x, k),
           "ms": time_ms(lambda: pool3_1x1(x, k), iters),
           "plain_ms": time_ms(lambda: pool3_1x1_plain(x, k),
                               max(1, iters // 4), warmup=1),
           "library_ms": time_ms(library, iters),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return rec


class Mixed(InceptionModule):
    """One inception module as the TPU tool builds it: the port's unfused
    module in bf16 (Unit3D branches, the b0 | b1a | b2a 1x1 convs as one
    conv, b3 = ``b3b(max_pool_same(x))``), except that with ``use_k4`` and
    C in ``CHAIN_K4_CHANNELS`` b3 is ``b3b.epilogue(pool3_1x1(x, k))``."""

    def __init__(self, cin: int, spec: Sequence[int], use_k4: bool):
        super().__init__(cin, spec, dtype=torch.bfloat16)
        self.use_k4 = use_k4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.use_k4 and x.shape[1] in CHAIN_K4_CHANNELS):
            return super().forward(x)
        o, dt = self.out_channels, torch.bfloat16
        k = torch.cat([self.b0.conv3d.weight, self.b1a.conv3d.weight,
                       self.b2a.conv3d.weight])
        y = F.conv3d(cast(x, dt), cast(k, dt))
        y0, y1, y2 = torch.split(y, [o[0], o[1], o[3]], dim=1)
        kk = self.b3b.conv3d.weight.reshape(o[5], -1).t().contiguous()
        xk = cast(x, dt).contiguous(memory_format=CHANNELS_LAST)
        return torch.cat([self.b0.epilogue(y0),
                          self.b1b(self.b1a.epilogue(y1)),
                          self.b2b(self.b2a.epilogue(y2)),
                          self.b3b.epilogue(pool3_1x1(xk, cast(kk, dt)))],
                         dim=1)


def build_chain(use_k4: bool, seed: int = 0) -> nn.Sequential:
    """Mixed_4b..4f in eval mode, weights from ``seed``, on the CPU."""
    cin, mods = CHAIN_INPUT[-1], []
    for name, spec in I3D_STAGES:
        if name.startswith("Mixed_4"):
            mods.append(Mixed(cin, spec, use_k4))
            cin = module_channels(spec)
    chain = nn.Sequential(*mods)
    init_parameters(chain, torch.Generator().manual_seed(seed))
    return chain.eval()


def chain(use_k4: bool, gen: torch.Generator,
          x: Optional[torch.Tensor] = None, iters: int = 5) -> dict:
    """The Mixed_4 chain's device ms in bf16, b3 through K4 or cuDNN."""
    if x is None:
        x = torch.randn(*CHAIN_INPUT, device="cuda", generator=gen)
        x = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    model = build_chain(use_k4).to(x.device)
    with torch.inference_mode():
        ms = time_ms(lambda: model(x), iters)
    return {"mode": "chain", "k4_b3": use_k4, "input": list(CHAIN_INPUT),
            "chain_ms": ms}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mode = args[0] if args else ""
    if mode not in ("check", "chain", *TIME_SHAPES):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("pool1x1_experiment: needs a CUDA card", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    if mode == "check":
        records = check(gen)
    elif mode == "chain":
        records = [chain("cudnn" not in args, gen)]
    else:
        records = [time_case(shape, co, gen)
                   for shape, co in TIME_SHAPES[mode]]
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
