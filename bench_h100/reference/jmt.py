"""Plain reference of the joint multimodal transformer (flagship).

The model of Waligora et al., "Joint Multimodal Transformer for Emotion
Recognition in the Wild" (arXiv 2403.10488; the 6th ABAW code,
PoloWlg/Joint-Multimodal-Transformer-6th-ABAW), written as plain torch
functions over a dict of weights keyed as that code's state dict:

* preprocessing: the clips' colour augmentation (train step) and
  per-channel normalisation; the log-mel front end (torchaudio's
  MelSpectrogram 44.1 kHz, n_fft 1024, hop 441, 64 HTK mels, power 2 ->
  AmplitudeToDB(top_db 80) -> Normalize(-14.8, 19.895));
* R(2+1)D-18 (MAX over the layer4 map), ResNet-18 on the log-mel,
  I3D (112 -> 224 bilinear upsample, TF-SAME convs and pools, BN eps
  1e-3) + TCN (4 weight-normed causal blocks, k 5) with a max over time;
* the intra-modal fusions (a 2-token post-LN encoder and an MHA, token
  -1; wavLM's 768 -> 512 fc), L2 normalisation, the JMT (joint
  representation, three encoders, six cross-attentions, a SELF_ATTEN
  head over the 6 outputs) and the V/A regressors.

It imports nothing but torch and numpy. Every conv and linear goes
through an ``Ops`` object, which says how its operands are rounded:
``Ops`` is float32 as it is (the caller turns TF32 off, ``no_tf32``),
``Bf16Ops`` rounds operands, outputs and activations to bfloat16 where a
bf16 configuration holds them, ``QuantOps`` and ``Bf16QuantOps`` are the
static int8 arithmetic of the served int8 model (``Int4Ops``, its
control, in int4), ``Fp8Ops`` rounds to e4m3 where ``Bf16Ops`` rounds to
bf16, and ``bench_h100/counts.py`` records shapes on the meta device.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
Pads = Tuple[Tuple[int, int], ...]
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}

VIS_MEAN = (0.43216, 0.394666, 0.37645)
VIS_STD = (0.22803, 0.22145, 0.216989)
LUMA = (0.299, 0.587, 0.114)
SAMPLE_RATE, N_FFT, WIN_LENGTH, HOP, N_MELS = 44100, 1024, 882, 441, 64
SPEC_MEAN, SPEC_STD, TOP_DB = -14.8, 19.895, 80.0
E = 512
# int8 convs: contraction (Cin x window) of at least this many taps
MIN_CONTRACTION = 64

R2D1 = "backbones.vision_r2d1.r2plus1d."
RESNET = "backbones.audio_resnet18.resnet."
I3D = "backbones.vision_i3d.i3d_WSDDA."
TCN = "backbones.vision_i3d.temporal.network."
JMT = "fusion_model.mm_transformer."
# (name, channel spec (o0..o5) or None, pool before it (kernel, strides))
I3D_MODULES = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32), ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64), None),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64), ((3, 3, 3), (1, 2, 2))),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64), None),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64), None),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64), None),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128), None),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128), ((2, 2, 2), (1, 2, 2))),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128), None),
)


def check_config(model: dict) -> None:
    """The reference covers the flagship's lattice point only."""
    want = {"vision_backbones": ["R2D1", "I3D"],
            "audio_backbones": ["ResNet18", "wavLM"],
            "intra_modal_fusion": "encoder_plus_self_attention",
            "joint_modalities": "TRANSFORMER", "output_format": "SELF_ATTEN",
            "r2d1_reduce": "MAX"}
    for k, v in want.items():
        got = model.get(k)
        if (list(got) if isinstance(got, (list, tuple)) else got) != v:
            raise NotImplementedError(f"the reference has {k}={v!r}, the "
                                      f"configuration {got!r}")


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 matmuls and convs in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# --------------------------------------------------------------- ops
def pad_arg(pads: Pads) -> list:
    return [v for p in reversed(pads) for v in p]


def sym(pads: Sequence[int]) -> Pads:
    return tuple((p, p) for p in pads)


class Ops:
    """float32 convs and linears. ``region`` marks the inception
    modules (``QuantOps`` leaves them in float, as the fused kernel
    runs them; the counts group them)."""

    batch_stats = False

    def __init__(self):
        self.regions: List[str] = []

    def begin(self) -> None:
        """A block of rows starts: the convs run again from the first."""

    @contextlib.contextmanager
    def region(self, name: str) -> Iterator[None]:
        self.regions.append(name)
        try:
            yield
        finally:
            self.regions.pop()

    def conv(self, x, w, stride=1, pads: Optional[Pads] = None,
             dilation=1):
        if pads is not None and any(p != (0, 0) for p in pads):
            x = F.pad(x, pad_arg(pads))
        return _CONV[w.ndim - 2](x, w, None, stride, 0, dilation)

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def attend(self, q, k, v):
        """softmax(q kᵀ) v over (B, L, H, hd), q pre-scaled; the
        probabilities held as an activation before the second product."""
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", self.act(att), v)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as it is held between layers: BN's and LayerNorm's
        inputs and outputs, residual sums, the backbones' features, the
        stem fold's border sums, the TCN's bias sums and leaky ReLUs, the
        L2-normalized streams and their norms, the attention's scale and
        probabilities (the convs', linears' and attention's outputs
        through their methods)."""
        return x

    def note(self, kind: str, x: torch.Tensor, out: torch.Tensor,
             weights: Sequence[torch.Tensor]) -> None:
        """A unit that one kernel computes whole (an inception module):
        its input, output and weights. Only the counts read it."""


class QuantOps(Ops):
    """Static symmetric fake quantization of every eligible conv
    (contraction >= 64, outside ``exclude`` regions): activations per
    tensor, ``clip(round(x / s_x), -L, L)`` with the next scale of
    ``scales`` in execution order; weights per output channel, ``s_w =
    max(max|w| / L, 1e-12)``; the integer product times ``s_x * s_w``.
    ``levels`` L = 127 is int8, 7 int4. With ``scales=None`` it
    calibrates: each eligible conv records max |x| (the max over the
    blocks of rows of one forward) and runs in float."""

    def __init__(self, levels: int = 127,
                 scales: Optional[Sequence[float]] = None,
                 exclude: Sequence[str] = ("inception",)):
        super().__init__()
        self.levels = levels
        self.scales = None if scales is None else list(scales)
        self.exclude = tuple(exclude)
        self.pos = 0
        self.maxes: List[torch.Tensor] = []

    def begin(self) -> None:
        self.pos = 0

    def eligible(self, w) -> bool:
        return (math.prod(w.shape[1:]) >= MIN_CONTRACTION
                and not any(r in self.exclude for r in self.regions))

    def conv(self, x, w, stride=1, pads=None, dilation=1):
        if not self.eligible(w):
            return super().conv(x, w, stride, pads, dilation)
        if pads is not None and any(p != (0, 0) for p in pads):
            x = F.pad(x, pad_arg(pads))
        if self.scales is None:
            m = x.detach().abs().amax().float()
            if self.pos == len(self.maxes):
                self.maxes.append(m)
            else:
                self.maxes[self.pos] = torch.maximum(self.maxes[self.pos], m)
            self.pos += 1
            return super().conv(x, w, stride, None, dilation)
        if self.pos >= len(self.scales):
            raise RuntimeError("the reference runs more eligible convs "
                               "than it calibrated")
        s_x = self.scales[self.pos]
        self.pos += 1
        lv = self.levels
        qx = torch.clamp(torch.round(x / s_x), -lv, lv)
        s_w = torch.clamp_min(w.abs().reshape(w.shape[0], -1).amax(1) / lv,
                              1e-12)
        qw = torch.clamp(torch.round(w / s_w.view(-1, *[1] * (w.ndim - 1))),
                         -lv, lv)
        acc = super().conv(qx, qw, stride, None, dilation)
        return acc * (s_x * s_w).view(1, -1, *[1] * (acc.ndim - 2))

    def scales_from_maxes(self) -> List[float]:
        """The calibrated maxes as static scales ``max(m, 1e-12) / L``."""
        flat = torch.stack(self.maxes).cpu().tolist() if self.maxes else []
        return [max(m, 1e-12) / self.levels for m in flat]


class BatchStatsOps(Ops):
    """float32, each BN's running statistics set to those of the batch
    it sees, layer after layer: BN statistics as a trained model's are,
    the data's, so that every BN output is normalized."""

    batch_stats = True


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even); the gradient passes straight
    through."""
    return x + (x.detach().to(torch.bfloat16).float() - x).detach()


class Bf16Ops(Ops):
    """The reference at a bf16 configuration's stated precision: every
    conv's, linear's and attention's operands (weights and biases with
    them) and outputs, and every activation between layers
    (``Ops.act``), rounded to bfloat16, with float32 accumulation and
    float32 BN, LayerNorm and softmax, as the program holds them.
    ``round`` is the rounding; ``Fp8Ops`` puts e4m3 in its place."""

    round = staticmethod(_bf16)

    def conv(self, x, w, stride=1, pads=None, dilation=1):
        r = self.round
        return r(Ops.conv(self, r(x), r(w), stride, pads, dilation))

    def linear(self, x, w, b=None):
        r = self.round
        return r(F.linear(r(x), r(w), None if b is None else r(b)))

    def attend(self, q, k, v):
        r = self.round
        return r(Ops.attend(self, r(q), r(k), r(v)))

    def act(self, x):
        return self.round(x)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (amax -> 448); the
    gradient passes straight through."""
    s = torch.clamp_min(x.detach().abs().amax(), 1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class Fp8Ops(Bf16Ops):
    """The reference computed in float8 e4m3 where a bf16 configuration
    holds bf16 (per-tensor scales, float32 accumulation and float32 BN,
    LayerNorm and softmax): the control of a bf16 configuration."""

    round = staticmethod(_fp8)


class Bf16QuantOps(QuantOps):
    """Static int8 (``QuantOps``) of a bf16 configuration: each eligible
    conv quantizes its bf16 input (the scales calibrated on bf16
    activations) and rounds its output to bf16; the rest as ``Bf16Ops``."""

    round = staticmethod(_bf16)
    linear = Bf16Ops.linear
    attend = Bf16Ops.attend
    act = Bf16Ops.act

    def conv(self, x, w, stride=1, pads=None, dilation=1):
        r = self.round
        if self.eligible(w):
            return r(super().conv(r(x), w, stride, pads, dilation))
        return r(Ops.conv(self, r(x), r(w), stride, pads, dilation))


class Int4Ops(Bf16QuantOps):
    """The control of a static int8 configuration: its int8 convs in int4
    (7 levels, static scales), and what it computes in bf16 in e4m3."""

    round = staticmethod(_fp8)

    def __init__(self, scales: Optional[Sequence[float]] = None):
        super().__init__(7, scales)


# ------------------------------------------------------- preprocessing
def preprocess_clips(clips_u8: torch.Tensor,
                     brightness: Optional[torch.Tensor] = None,
                     contrast: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(N, T, H, W, 3) uint8 -> normalized float32; with the (N,)
    factors first the colour augmentation: brightness (scale, clamp to
    [0, 255]), then contrast (blend with the clip's mean luma, clamp)."""
    dev = clips_u8.device
    mean, std, luma = (torch.tensor(v, device=dev)
                       for v in (VIS_MEAN, VIS_STD, LUMA))
    x = clips_u8.float()
    if brightness is not None:
        shape = (-1, 1, 1, 1, 1)
        x = torch.clamp(x * brightness.view(shape), 0.0, 255.0)
        gray = (x * luma).sum(-1).mean(dim=(1, 2, 3)).view(shape)
        c = contrast.view(shape)
        x = torch.clamp(c * x + (1.0 - c) * gray, 0.0, 255.0)
    return (x / 255.0 - mean) / std


def _mel_filterbank(n_freqs: int = N_FFT // 2 + 1) -> np.ndarray:
    """HTK triangular filterbank (n_freqs, 64), f_min 0, f_max sr/2."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, SAMPLE_RATE // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2),
                                  N_MELS + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(audio: torch.Tensor) -> torch.Tensor:
    """(N, L) wavs -> normalized log-mel (N, 64, 1 + L // 441)."""
    dev = audio.device
    n = np.arange(WIN_LENGTH)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / WIN_LENGTH))
    window = np.zeros(N_FFT, np.float32)
    lpad = (N_FFT - WIN_LENGTH) // 2
    window[lpad:lpad + WIN_LENGTH] = hann
    x = F.pad(audio.float()[:, None, :], (N_FFT // 2, N_FFT // 2),
              mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)                      # (N, T, n_fft)
    spec = torch.fft.rfft(frames * torch.from_numpy(window).to(dev), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = (power @ torch.from_numpy(_mel_filterbank()).to(dev)
           ).transpose(1, 2)                               # (N, 64, T)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - TOP_DB)
    return (db - SPEC_MEAN) / SPEC_STD


# ----------------------------------------------------------- backbones
def bn(ops: "Ops", w: Weights, p: str, x: torch.Tensor, eps: float = 1e-5
       ) -> torch.Tensor:
    """Eval BatchNorm over channel axis 1 with the running statistics
    (under ``BatchStatsOps``: first set to the batch's own)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if ops.batch_stats:
        dims = [0] + list(range(2, x.ndim))
        w[p + ".running_mean"].copy_(x.mean(dims))
        w[p + ".running_var"].copy_(x.var(dims, unbiased=False))
    return ops.act((x - w[p + ".running_mean"].view(shape))
                   / torch.sqrt(w[p + ".running_var"].view(shape) + eps)
                   * w[p + ".weight"].view(shape) + w[p + ".bias"].view(shape))


def midplanes(inp: int, out: int) -> int:
    return (inp * out * 3 * 3 * 3) // (inp * 3 * 3 + 3 * out)


def r2plus1d(ops: Ops, w: Weights, x: torch.Tensor) -> torch.Tensor:
    """R(2+1)D-18: (N, 3, T, H, W) -> layer4 map (N, 512, T', H', W')."""
    p = R2D1
    h = F.relu(bn(ops, w, p + "stem.1", ops.conv(
        x, w[p + "stem.0.weight"], (1, 2, 2), sym((0, 3, 3)))))
    h = F.relu(bn(ops, w, p + "stem.4", ops.conv(
        h, w[p + "stem.3.weight"], 1, sym((1, 0, 0)))))

    def conv2plus1d(q, x, s):
        y = ops.conv(x, w[q + ".0.weight"], (1, s, s), sym((0, 1, 1)))
        y = F.relu(bn(ops, w, q + ".1", y))
        return ops.conv(y, w[q + ".3.weight"], (s, 1, 1), sym((1, 0, 0)))

    inplanes = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            stride = 2 if li > 1 and bi == 0 else 1
            q = f"{p}layer{li}.{bi}."
            y = F.relu(bn(ops, w, q + "conv1.1", conv2plus1d(q + "conv1.0", h,
                                                        stride)))
            y = bn(ops, w, q + "conv2.1", conv2plus1d(q + "conv2.0", y, 1))
            res = h
            if stride != 1 or inplanes != planes:
                res = bn(ops, w, q + "downsample.1", ops.conv(
                    h, w[q + "downsample.0.weight"], stride))
            h = F.relu(ops.act(y + res))
            inplanes = planes
    return h


def resnet18(ops: Ops, w: Weights, x: torch.Tensor) -> torch.Tensor:
    """ResNet-18 on (N, 1, 64, T) log-mel -> (N, 512)."""
    p = RESNET
    h = F.relu(bn(ops, w, p + "bn1", ops.conv(x, w[p + "conv1.weight"], 2,
                                         sym((3, 3)))))
    h = F.max_pool2d(h, 3, 2, 1)
    inplanes = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            stride = 2 if li > 1 and bi == 0 else 1
            q = f"{p}layer{li}.{bi}."
            y = F.relu(bn(ops, w, q + "bn1", ops.conv(h, w[q + "conv1.weight"],
                                                 stride, sym((1, 1)))))
            y = bn(ops, w, q + "bn2", ops.conv(y, w[q + "conv2.weight"], 1,
                                          sym((1, 1))))
            res = h
            if stride != 1 or inplanes != planes:
                res = bn(ops, w, q + "downsample.1", ops.conv(
                    h, w[q + "downsample.0.weight"], stride))
            h = F.relu(ops.act(y + res))
            inplanes = planes
    return ops.act(h.mean(dim=(2, 3)))


def tf_same_pads(sizes, kernel, strides) -> Pads:
    """TF 'SAME' (front, back) pads: pad = max(k - s, 0) if size % s == 0
    else max(k - size % s, 0); front = pad // 2."""
    out = []
    for size, k, s in zip(sizes, kernel, strides):
        pad = max(k - s, 0) if size % s == 0 else max(k - size % s, 0)
        out.append((pad // 2, pad - pad // 2))
    return tuple(out)


def max_pool_same(x: torch.Tensor, kernel, strides) -> torch.Tensor:
    pads = tf_same_pads(x.shape[2:], kernel, strides)
    if any(p != (0, 0) for p in pads):
        x = F.pad(x, pad_arg(pads), value=-math.inf)
    return F.max_pool3d(x, tuple(kernel), tuple(strides))


def unit3d(ops: Ops, w: Weights, p: str, x: torch.Tensor, kernel,
           stride=(1, 1, 1)) -> torch.Tensor:
    """TF-SAME conv without bias, BN (eps 1e-3), ReLU."""
    y = ops.conv(x, w[p + ".conv3d.weight"], tuple(stride),
                 tf_same_pads(x.shape[2:], kernel, stride))
    return F.relu(bn(ops, w, p + ".bn", y, eps=1e-3))


# (2x bilinear half-pixel upsample) o (7-tap stride-2 conv), per axis: the
# 7 taps land on 5 taps of the edge-clamped input, w5 = FOLD @ w7
_FOLD = np.zeros((5, 7))
for _d, _t, _v in ((0, 0, .25), (1, 0, .75), (1, 1, .75), (1, 2, .25),
                   (2, 1, .25), (2, 2, .75), (2, 3, .75), (2, 4, .25),
                   (3, 3, .25), (3, 4, .75), (3, 5, .75), (3, 6, .25),
                   (4, 5, .25), (4, 6, .75)):
    _FOLD[_d, _t] = _v
# the conv's zero padding on the 2n grid drops taps the fold still counts,
# in multiples of the edge pixel: per-tap coefficients at the border outputs
_BORDER = {"lo": (.75, 1., 0., 0., 0., 0., 0.),
           "hi1": (0., 0., 0., 0., 0., 0., 1.),
           "hi0": (0., 0., 0., 0., 1., .75, .25)}


def stem_folded(ops: Ops, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The I3D stem conv (kt x 7 x 7, stride (1, 2, 2), TF-SAME) of the 2x
    upsampled x, computed on x: one 7 x 5 x 5 conv over the edge-replicated
    and zero-padded x, less the border terms of the dropped taps. The
    served model computes the stem so, and its int8 convs are these."""
    kt = w.shape[2]
    h, wd = x.shape[3], x.shape[4]
    dev = w.device
    m = torch.tensor(_FOLD, dtype=torch.float32, device=dev)
    al = {k: torch.tensor(v, dtype=torch.float32, device=dev)
          for k, v in _BORDER.items()}
    t0, t1 = tf_same_pads((x.shape[2],), (kt,), (1,))[0]
    xz = F.pad(F.pad(x, (1, 1, 1, 1, 0, 0), mode="replicate"), (1, 1, 1, 1))
    k5 = torch.einsum("ah,bw,oithw->oitab", m, m, w)
    out = ops.conv(F.pad(xz, (0, 0, 0, 0, t0, t1)), k5)
    rows = {0: ("lo", 0), h - 2: ("hi1", h - 1), h - 1: ("hi0", h - 1)}
    cols = {0: ("lo", 0), wd - 2: ("hi1", wd - 1), wd - 1: ("hi0", wd - 1)}
    out = out.clone()
    for j, (k, src) in rows.items():
        krow = torch.einsum("h,bw,oithw->oitb", al[k], m, w)
        row = xz[:, :, :, src + 2, :]
        out[:, :, :, j, :] = ops.act(out[:, :, :, j, :] - ops.conv(
            F.pad(row, (0, 0, t0, t1)), krow))
    for j, (k, src) in cols.items():
        kcol = torch.einsum("w,ah,oithw->oita", al[k], m, w)
        col = xz[:, :, :, :, src + 2]
        out[:, :, :, :, j] = ops.act(out[:, :, :, :, j] - ops.conv(
            F.pad(col, (0, 0, t0, t1)), kcol))
    for jh, (kh, sh) in rows.items():
        for jw, (kw, sw) in cols.items():
            kc = torch.einsum("h,w,oithw->oit", al[kh], al[kw], w)
            px = x[:, :, :, sh, sw]
            out[:, :, :, jh, jw] = ops.act(out[:, :, :, jh, jw] + ops.conv(
                F.pad(px, (t0, t1)), kc))
    return out


def inception(ops: Ops, w: Weights, p: str, x: torch.Tensor,
              pool_in, avg_tail: bool) -> torch.Tensor:
    """One inception module (its preceding max pool first)."""
    with ops.region("inception"):
        if pool_in is not None:
            x = max_pool_same(x, *pool_in)
        x_in = x
        b0 = unit3d(ops, w, p + ".b0", x, (1, 1, 1))
        b1 = unit3d(ops, w, p + ".b1b",
                    unit3d(ops, w, p + ".b1a", x, (1, 1, 1)), (3, 3, 3))
        b2 = unit3d(ops, w, p + ".b2b",
                    unit3d(ops, w, p + ".b2a", x, (1, 1, 1)), (3, 3, 3))
        b3 = unit3d(ops, w, p + ".b3b",
                    max_pool_same(x, (3, 3, 3), (1, 1, 1)), (1, 1, 1))
        out = torch.cat([b0, b1, b2, b3], dim=1)
        if avg_tail:   # AvgPool3d((2, H, W), stride 1) -> (N, T-1, C)
            out = ops.act(F.avg_pool3d(out, (2, out.shape[3], out.shape[4]),
                                       1))
            out = out.flatten(2).transpose(1, 2)
        ops.note("inception", x_in, out,
                 [w[f"{p}.{br}.{t}"] for br in ("b0", "b1a", "b1b", "b2a",
                                                "b2b", "b3b")
                  for t in ("conv3d.weight", "bn.bias")])
    return out


def i3d_tcn(ops: Ops, w: Weights, x: torch.Tensor, input_size: int,
            fold: bool) -> torch.Tensor:
    """I3D + TCN: (N, 3, T, H, W) clips -> (N, 512), the max over time.
    The clips are upsampled to ``input_size`` (bilinear, half-pixel
    centres); ``fold`` computes a 2x upsample inside the stem
    (``stem_folded``) instead."""
    p = I3D
    stem = p + "Conv3d_1a_7x7"
    if fold:
        if input_size != 2 * x.shape[3]:
            raise ValueError("the stem fold is of a 2x upsample")
        y = stem_folded(ops, w[stem + ".conv3d.weight"], x)
        h = F.relu(bn(ops, w, stem + ".bn", y, eps=1e-3))
    else:
        if input_size != x.shape[3]:
            x = F.interpolate(x, size=(x.shape[2], input_size, input_size),
                              mode="trilinear", align_corners=False)
        h = unit3d(ops, w, stem, x, (7, 7, 7), (1, 2, 2))
    h = max_pool_same(h, (1, 3, 3), (1, 2, 2))
    h = unit3d(ops, w, p + "Conv3d_2b_1x1", h, (1, 1, 1))
    h = unit3d(ops, w, p + "Conv3d_2c_3x3", h, (3, 3, 3))
    for name, _, pool in I3D_MODULES:
        h = inception(ops, w, p + name, h, pool, name == "Mixed_5c")
    h = h.transpose(1, 2)                               # (N, 1024, T-1)
    for i in range(4):
        q, d = f"{TCN}{i}.", 2 ** i

        def wn_conv(c, x):
            v, g = w[c + ".weight_v"], w[c + ".weight_g"]
            wt = g / torch.sqrt((v ** 2).sum(dim=(1, 2), keepdim=True)) * v
            y = ops.conv(F.pad(x, ((v.shape[-1] - 1) * d, 0)), wt,
                         dilation=d)
            return ops.act(y + ops.act(w[c + ".bias"][:, None]))

        y = ops.act(F.leaky_relu(wn_conv(q + "conv1", h), 0.01))
        y = ops.act(F.leaky_relu(wn_conv(q + "conv2", y), 0.01))
        res = h
        if q + "downsample.weight" in w:
            res = ops.act(ops.conv(h, w[q + "downsample.weight"])
                          + ops.act(w[q + "downsample.bias"][:, None]))
        h = ops.act(F.leaky_relu(ops.act(y + res), 0.01))
    return torch.amax(h, dim=2)


def backbone_features(ops: Ops, w: Weights, model: dict,
                      clips: torch.Tensor, spec: torch.Tensor,
                      fold: bool = False) -> Dict[str, torch.Tensor]:
    """clips (N, T, H, W, 3) normalized, spec (N, 64, T') -> each
    backbone's (N, 512) features."""
    v = clips.permute(0, 4, 1, 2, 3)
    return {"audio": resnet18(ops, w, spec[:, None]),
            "r2d1": torch.amax(r2plus1d(ops, w, v), dim=(2, 3, 4)),
            "i3d": i3d_tcn(ops, w, v, model["i3d_input_size"], fold)}


# -------------------------------------------------------------- fusion
def mha(ops: Ops, w: Weights, p: str, q_in, k_in, v_in,
        heads: int) -> torch.Tensor:
    """torch MultiheadAttention, batch-first (B, L, E), no masks."""
    e = q_in.shape[-1]
    hd = e // heads
    wq, wk, wv = w[p + ".in_proj_weight"].chunk(3)
    bq, bk, bv = w[p + ".in_proj_bias"].chunk(3)
    b, lq, lk = q_in.shape[0], q_in.shape[1], k_in.shape[1]
    scale = float(ops.act(torch.tensor(hd ** -0.5)))
    q = (ops.linear(q_in, wq, bq) * scale).view(b, lq, heads, hd)
    k = ops.linear(k_in, wk, bk).view(b, lk, heads, hd)
    v = ops.linear(v_in, wv, bv).view(b, lk, heads, hd)
    out = ops.attend(q, k, v).reshape(b, lq, e)
    return ops.linear(out, w[p + ".out_proj.weight"],
                      w[p + ".out_proj.bias"])


def encoder(ops: Ops, w: Weights, p: str, x: torch.Tensor, heads: int,
            layers: int) -> torch.Tensor:
    """Post-LN layers: LN1(x + MHA(x)), LN2(x + FF(x))."""
    for i in range(layers):
        q = f"{p}.layers.{i}."
        x = ops.act(F.layer_norm(
            ops.act(x + mha(ops, w, q + "attention", x, x, x, heads)),
            (x.shape[-1],), w[q + "layer_norm1.weight"],
            w[q + "layer_norm1.bias"]))
        ff = ops.linear(F.relu(ops.linear(
            x, w[q + "feed_forward.0.weight"], w[q + "feed_forward.0.bias"])),
            w[q + "feed_forward.2.weight"], w[q + "feed_forward.2.bias"])
        x = ops.act(F.layer_norm(ops.act(x + ff), (x.shape[-1],),
                                 w[q + "layer_norm2.weight"],
                                 w[q + "layer_norm2.bias"]))
    return x


def token_mix(ops: Ops, w: Weights, p: str, tokens: List[torch.Tensor],
              heads: int, layers: int) -> torch.Tensor:
    """(B, L, E) tokens -> encoder and MHA over them per (b, l) -> token
    -1, (B, L, E)."""
    stack = torch.stack(tokens, dim=2)
    b, l, k, e = stack.shape
    enc = encoder(ops, w, p + ".final_visual_encoder",
                  stack.reshape(b * l, k, e), heads, layers)
    att = mha(ops, w, p + ".final_self_attention", enc, enc, enc, heads)
    return att.reshape(b, l, k, e)[:, :, -1, :]


def intra_modal(ops: Ops, w: Weights, p: str, a, b, heads, layers):
    """'encoder_plus_self_attention' over two streams; a 768-d one
    through the shared fc first."""
    def fit(x):
        if x.shape[-1] == 768:
            return ops.linear(x, w[p + ".fc.weight"], w[p + ".fc.bias"])
        return x
    return token_mix(ops, w, p, [fit(a), fit(b)], heads, layers)


def l2_normalize(ops: Ops, x: torch.Tensor) -> torch.Tensor:
    """x over its norm, the norm held as an activation."""
    return ops.act(x / ops.act(torch.clamp(x.norm(dim=-1, keepdim=True),
                                           min=1e-12)))


def regressor(ops: Ops, w: Weights, p: str, x) -> torch.Tensor:
    h = F.relu(ops.linear(x, w[p + ".0.weight"], w[p + ".0.bias"]))
    return ops.linear(h, w[p + ".3.weight"], w[p + ".3.bias"])[..., 0]


def fusion(ops: Ops, w: Weights, model: dict, feats: Dict[str, torch.Tensor],
           wavlm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone features (B, S, 512) each and wavLM (B, S, 768) -> (V, A),
    each (B, S)."""
    heads, layers = model["num_heads"], model["num_layers"]
    visual = intra_modal(ops, w, "transformer_visio_modality_fusion",
                         feats["r2d1"], feats["i3d"], heads, layers)
    audio = intra_modal(ops, w, "transformer_audio_modality_fusion",
                        feats["audio"], wavlm, heads, layers)
    video, audio = l2_normalize(ops, visual), l2_normalize(ops, audio)
    joint = ops.linear(torch.cat([video, audio], -1),
                       w[JMT + "out_layer_pv.weight"],
                       w[JMT + "out_layer_pv.bias"])
    v_enc = encoder(ops, w, JMT + "visual_encoder", video, heads, layers)
    a_enc = encoder(ops, w, JMT + "physiological_encoder", audio, heads,
                    layers)
    j_enc = encoder(ops, w, JMT + "joint_representation_encoder", joint,
                    heads, layers)

    def cross(name, q, kv):
        return mha(ops, w, JMT + name, q, kv, kv, heads)

    outs = [cross("cross_attention_v", v_enc, a_enc),
            cross("cross_attention_p", a_enc, v_enc),
            cross("cross_attention_pv", j_enc, v_enc),
            cross("cross_attention_v", v_enc, j_enc),
            cross("cross_attention_pv", j_enc, a_enc),
            cross("cross_attention_p", a_enc, j_enc)]
    feats = token_mix(ops, w, JMT[:-1], outs, heads, layers)
    return (regressor(ops, w, "fusion_model.vregressor", feats),
            regressor(ops, w, "fusion_model.aregressor", feats))


def forward_features(ops: Ops, w: Weights, model: dict,
                     clips_u8: torch.Tensor, audio: torch.Tensor,
                     color: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     fold: bool = False, block: int = 32
                     ) -> Dict[str, torch.Tensor]:
    """clips (B, S, T, H, W, 3) uint8, audio (B, S, L) -> each backbone's
    (B, S, 512) features, ``block`` clips at a time. ``color``: the (B*S,)
    brightness and contrast factors of the train step."""
    b, s = clips_u8.shape[:2]
    flat = clips_u8.reshape(b * s, *clips_u8.shape[2:])
    wav = audio.reshape(b * s, audio.shape[-1])
    parts: Dict[str, list] = {"audio": [], "r2d1": [], "i3d": []}
    for i in range(0, b * s, block):
        ops.begin()
        sl = slice(i, i + block)
        cl = preprocess_clips(flat[sl], *(None, None) if color is None
                              else (color[0][sl], color[1][sl]))
        got = backbone_features(ops, w, model, cl, log_mel(wav[sl]), fold)
        for k, v in got.items():
            parts[k].append(v)
    return {k: torch.cat(v).reshape(b, s, -1) for k, v in parts.items()}


def forward(ops: Ops, w: Weights, model: dict, clips_u8, audio, wavlm,
            color=None, fold: bool = False, block: int = 32):
    """The eval forward: (V, A), each (B, S)."""
    feats = forward_features(ops, w, model, clips_u8, audio, color, fold,
                             block)
    return fusion(ops, w, model, feats, wavlm.float())


# -------------------------------------------------------------- layout
def layout(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every weight and BN statistic of the model: (name, shape, kind),
    kind one of conv, linear, bias, scale, shift, mean, var, wn_v, wn_g.
    The names are the published code's state-dict keys."""
    check_config(model)
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def conv(name, *shape):
        out.append((name + ".weight", tuple(shape), "conv"))

    def norm(name, c, stats=True):
        out.append((name + ".weight", (c,), "scale"))
        out.append((name + ".bias", (c,), "shift"))
        if stats:
            out.append((name + ".running_mean", (c,), "mean"))
            out.append((name + ".running_var", (c,), "var"))

    def linear(name, i, o):
        out.append((name + ".weight", (o, i), "linear"))
        out.append((name + ".bias", (o,), "bias"))

    def attention(name):
        out.append((name + ".in_proj_weight", (3 * E, E), "linear"))
        out.append((name + ".in_proj_bias", (3 * E,), "bias"))
        linear(name + ".out_proj", E, E)

    def encoder_block(name, layers):
        for i in range(layers):
            q = f"{name}.layers.{i}."
            attention(q + "attention")
            linear(q + "feed_forward.0", E, E)
            linear(q + "feed_forward.2", E, E)
            norm(q + "layer_norm1", E, stats=False)
            norm(q + "layer_norm2", E, stats=False)

    p = R2D1
    conv(p + "stem.0", 45, 3, 1, 7, 7)
    norm(p + "stem.1", 45)
    conv(p + "stem.3", 64, 45, 3, 1, 1)
    norm(p + "stem.4", 64)
    inplanes = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            stride = 2 if li > 1 and bi == 0 else 1
            q = f"{p}layer{li}.{bi}."
            mid = midplanes(inplanes, planes)
            for c, cin in (("conv1", inplanes), ("conv2", planes)):
                conv(f"{q}{c}.0.0", mid, cin, 1, 3, 3)
                norm(f"{q}{c}.0.1", mid)
                conv(f"{q}{c}.0.3", planes, mid, 3, 1, 1)
                norm(f"{q}{c}.1", planes)
            if stride != 1 or inplanes != planes:
                conv(q + "downsample.0", planes, inplanes, 1, 1, 1)
                norm(q + "downsample.1", planes)
            inplanes = planes
    p = I3D

    def unit(name, cin, cout, k):
        conv(name + ".conv3d", cout, cin, *k)
        norm(name + ".bn", cout)

    unit(p + "Conv3d_1a_7x7", 3, 64, (7, 7, 7))
    unit(p + "Conv3d_2b_1x1", 64, 64, (1, 1, 1))
    unit(p + "Conv3d_2c_3x3", 64, 192, (3, 3, 3))
    cin = 192
    for name, o, _ in I3D_MODULES:
        q = p + name
        unit(q + ".b0", cin, o[0], (1, 1, 1))
        unit(q + ".b1a", cin, o[1], (1, 1, 1))
        unit(q + ".b1b", o[1], o[2], (3, 3, 3))
        unit(q + ".b2a", cin, o[3], (1, 1, 1))
        unit(q + ".b2b", o[3], o[4], (3, 3, 3))
        unit(q + ".b3b", cin, o[5], (1, 1, 1))
        cin = o[0] + o[2] + o[4] + o[5]
    for i in range(4):
        q = f"{TCN}{i}."
        ci = 1024 if i == 0 else 512
        for c, n_in in (("conv1", ci), ("conv2", 512)):
            out.append((f"{q}{c}.weight_g", (512, 1, 1), "wn_g"))
            out.append((f"{q}{c}.weight_v", (512, n_in, 5), "wn_v"))
            out.append((f"{q}{c}.bias", (512,), "bias"))
        if ci != 512:
            conv(q + "downsample", 512, ci, 1)
            out.append((q + "downsample.bias", (512,), "bias"))
    p = RESNET
    conv(p + "conv1", 64, 1, 7, 7)
    norm(p + "bn1", 64)
    inplanes = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            stride = 2 if li > 1 and bi == 0 else 1
            q = f"{p}layer{li}.{bi}."
            conv(q + "conv1", planes, inplanes, 3, 3)
            norm(q + "bn1", planes)
            conv(q + "conv2", planes, planes, 3, 3)
            norm(q + "bn2", planes)
            if stride != 1 or inplanes != planes:
                conv(q + "downsample.0", planes, inplanes, 1, 1)
                norm(q + "downsample.1", planes)
            inplanes = planes
    heads, layers = model["num_heads"], model["num_layers"]
    if E % heads:
        raise ValueError(f"E={E} is not divisible by {heads} heads")
    for name in ("transformer_visio_modality_fusion",
                 "transformer_audio_modality_fusion"):
        encoder_block(name + ".final_visual_encoder", layers)
        attention(name + ".final_self_attention")
        linear(name + ".fc", 768, E)
    for name in ("visual_encoder", "physiological_encoder",
                 "joint_representation_encoder"):
        encoder_block(JMT + name, layers)
    for name in ("cross_attention_v", "cross_attention_p",
                 "cross_attention_pv"):
        attention(JMT + name)
    linear(JMT + "out_layer_pv", 2 * E, E)
    encoder_block(JMT + "final_visual_encoder", layers)
    attention(JMT + "final_self_attention")
    for name in ("fusion_model.vregressor", "fusion_model.aregressor"):
        linear(name + ".0", E, 128)
        linear(name + ".3", 128, 1)
    return out


def trainable(name: str) -> bool:
    """Every backbone is frozen (the trainer's defaults); the fusion
    layers train."""
    return not name.startswith("backbones.")
