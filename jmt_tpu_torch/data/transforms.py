"""Device-side clip preprocessing: colour augmentation and normalize.

Counterpart of ``jmt_tpu/data/transforms.py`` ``sample_color_factors`` and
``preprocess_clips``: uint8 in; with ``augment=True`` first the per-clip
brightness (multiply, clamp to [0, 255]) and contrast (blend with the mean
of the clip's luma over all its frames, clamp), the reference's
RandomColorAugment applied alike to a clip's frames; then / 255 and the
per-channel normalize with the reference's mean and std. Layout stays
channels-last (N, T, H, W, 3), the JAX package's layout; the backbones
convert to NCTHW.

The heavy vision augmentation (``use_more_vision_data_augm``, the
counterpart of JAX's ``more_vision_augment``) is split in two:
``sample_vision_augment`` draws each frame's parameters from a
``torch.Generator`` with JAX's distributions, and ``more_vision_augment``
applies given parameters: per frame a rotation (+-6 degrees) composed with
a square centre crop (area 0.8-1.0, random offset) as ONE bilinear
resample with zero padding back to the full size, a horizontal flip (p
0.5), grayscale (p 0.2), colour jitter (p 0.8: brightness, contrast and
saturation factors in 0.6-1.4, hue +-0.1 turns as a rotation of the YIQ
chroma plane), then / 255 and the normalize. It replaces the colour
augmentation, as in JAX.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

VIS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
VIS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)
# ITU-R 601-2 luma weights (PIL's 'L' conversion, which contrast uses)
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def sample_color_factors(generator: Optional[torch.Generator],
                         n_clips: int, brightness: float = 0.2,
                         contrast: float = 0.2, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-clip brightness and contrast factors ~ U(1 - b, 1 + b), drawn
    from ``generator`` on its device (torch's default generator of
    ``device`` when None)."""
    if generator is not None:
        device = generator.device

    def uniform(width):
        lo = max(0.0, 1 - width)
        u = torch.rand(n_clips, generator=generator, device=device)
        return lo + u * (1 + width - lo)

    bf = uniform(brightness)
    return bf, uniform(contrast)


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Mean, std and luma weights on ``device``, copied there once, so
    that a forward makes no host-to-device copy (a CUDA graph captures
    it)."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in (VIS_MEAN, VIS_STD, _LUMA))


def preprocess_clips(clips_u8: torch.Tensor,
                     brightness: Optional[torch.Tensor] = None,
                     contrast: Optional[torch.Tensor] = None,
                     augment: bool = False) -> torch.Tensor:
    """clips_u8: (..., 3) uint8 -> normalized float32 of the same shape.

    With ``augment``: clips (N, T, H, W, 3) and the (N,) factors of
    ``sample_color_factors``."""
    if clips_u8.dtype != torch.uint8:
        raise TypeError(f"preprocess_clips takes uint8, got {clips_u8.dtype}")
    dev = clips_u8.device
    mean, std, luma_weights = _constants(dev)
    x = clips_u8.float()
    if augment:
        if brightness is None or contrast is None:
            raise ValueError("augment=True takes brightness and contrast "
                             "factors (sample_color_factors)")
        if clips_u8.ndim != 5:
            raise ValueError(f"augment=True takes clips (N, T, H, W, 3), "
                             f"got {tuple(clips_u8.shape)}")
        shape = (-1, 1, 1, 1, 1)
        x = torch.clamp(x * brightness.to(dev).view(shape), 0.0, 255.0)
        gray = torch.einsum("nthwc,c->nthw", x, luma_weights)
        luma = torch.mean(gray, dim=(1, 2, 3)).view(shape)
        c = contrast.to(dev).view(shape)
        x = torch.clamp(c * x + (1.0 - c) * luma, 0.0, 255.0)
    return (x / 255.0 - mean) / std


# YIQ hue rotation (a linear stand-in for PIL's HSV hue shift)
_RGB2YIQ = np.array([[0.299, 0.587, 0.114],
                     [0.596, -0.274, -0.322],
                     [0.211, -0.523, 0.312]], np.float32)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


class VisionAugment(NamedTuple):
    """Per-frame (N*T,) parameters of ``more_vision_augment``: rotation
    ``angle`` (radians), crop ``scale`` (side / full side), crop offsets
    ``tx``, ``ty`` (in units of the half side), ``flip`` and ``gray``
    (bool), and the jitter factors ``brightness``, ``contrast``,
    ``saturation`` (1 = none) and ``hue`` (turns, 0 = none)."""
    angle: torch.Tensor
    scale: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    flip: torch.Tensor
    gray: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor

    def to(self, device) -> "VisionAugment":
        return VisionAugment(*(t.to(device) for t in self))


def sample_vision_augment(generator: Optional[torch.Generator],
                          n_frames: int, device=None) -> VisionAugment:
    """Each frame's parameters, JAX's distributions: angle U(-6, 6)
    degrees; crop area U(0.8, 1), side its square root, offsets U(-1, 1)
    times (1 - side); flip p 0.5; grayscale p 0.2; jitter p 0.8 with
    brightness, contrast, saturation U(0.6, 1.4) and hue U(-0.1, 0.1),
    all 1 (hue 0) in a frame without jitter. Drawn from ``generator`` on
    its device (torch's default generator of ``device`` when None)."""
    if generator is not None:
        device = generator.device

    def uniform(lo, hi):
        u = torch.rand(n_frames, generator=generator, device=device)
        return lo + u * (hi - lo)

    angle = uniform(-6.0, 6.0) * (np.pi / 180.0)
    side = torch.sqrt(uniform(0.8, 1.0))
    tx = uniform(-1.0, 1.0) * (1.0 - side)
    ty = uniform(-1.0, 1.0) * (1.0 - side)
    flip = uniform(0.0, 1.0) < 0.5
    gray = uniform(0.0, 1.0) < 0.2
    jit = (uniform(0.0, 1.0) < 0.8).float()
    bf, cf, sf = (1 + (uniform(0.6, 1.4) - 1) * jit for _ in range(3))
    return VisionAugment(angle, side, tx, ty, flip, gray, bf, cf, sf,
                         uniform(-0.1, 0.1) * jit)


def _affine_grid(h: int, w: int, p: VisionAugment):
    """Sampling coordinates (ys, xs), each (F, h, w), of the rotated and
    scaled crop."""
    dev = p.angle.device
    yy = (torch.arange(h, dtype=torch.float32, device=dev)
          - (h - 1) / 2)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev)
          - (w - 1) / 2)[None, None, :]
    c = torch.cos(p.angle)[:, None, None]
    s = torch.sin(p.angle)[:, None, None]
    sc = p.scale[:, None, None]
    ys = sc * (s * xx + c * yy) + p.ty[:, None, None] * (h - 1) / 2 \
        + (h - 1) / 2
    xs = sc * (c * xx - s * yy) + p.tx[:, None, None] * (w - 1) / 2 \
        + (w - 1) / 2
    return ys, xs


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """img (F, h, w, 3); ys, xs (F, h, w) -> (F, h, w, 3), zero outside."""
    f, h, w, _ = img.shape
    flat = img.reshape(f, h * w, 3)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0, x0 = y0.long(), x0.long()

    def at(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(f, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 3))
        return torch.where(valid, v.reshape(f, h, w, 3), 0.0)

    return ((1 - wy) * (1 - wx) * at(y0, x0)
            + (1 - wy) * wx * at(y0, x0 + 1)
            + wy * (1 - wx) * at(y0 + 1, x0)
            + wy * wx * at(y0 + 1, x0 + 1))


@functools.lru_cache(maxsize=8)
def _yiq(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in (_RGB2YIQ, _YIQ2RGB))


def more_vision_augment(clips_u8: torch.Tensor,
                        params: VisionAugment) -> torch.Tensor:
    """clips_u8 (N, T, H, W, 3) uint8 and the (N*T,) per-frame
    ``params`` -> normalized float32 (N, T, H, W, 3)."""
    if clips_u8.dtype != torch.uint8 or clips_u8.ndim != 5:
        raise TypeError(f"more_vision_augment takes uint8 (N, T, H, W, 3), "
                        f"got {clips_u8.dtype} {tuple(clips_u8.shape)}")
    n, t, h, w, _ = clips_u8.shape
    dev = clips_u8.device
    p = params.to(dev)
    mean, std, luma_weights = _constants(dev)
    rgb2yiq, yiq2rgb = _yiq(dev)
    x = clips_u8.float().reshape(n * t, h, w, 3)
    x = _bilinear_sample(x, *_affine_grid(h, w, p))
    x = torch.where(p.flip.view(-1, 1, 1, 1), x.flip(2), x)

    def luma(v):
        return torch.einsum("fhwc,c->fhw", v, luma_weights)

    x = torch.where(p.gray.view(-1, 1, 1, 1),
                    luma(x)[..., None].expand(-1, -1, -1, 3), x)
    shape = (-1, 1, 1, 1)
    x = torch.clamp(x * p.brightness.view(shape), 0, 255)
    gray_mean = torch.mean(luma(x), dim=(1, 2)).view(shape)
    cf = p.contrast.view(shape)
    x = torch.clamp(cf * x + (1 - cf) * gray_mean, 0, 255)
    sf = p.saturation.view(shape)
    x = torch.clamp(sf * x + (1 - sf) * luma(x)[..., None], 0, 255)
    theta = p.hue * (2 * np.pi)
    yiq = torch.einsum("fhwc,dc->fhwd", x, rgb2yiq)
    cth = torch.cos(theta)[:, None, None]
    sth = torch.sin(theta)[:, None, None]
    i2 = cth * yiq[..., 1] - sth * yiq[..., 2]
    q2 = sth * yiq[..., 1] + cth * yiq[..., 2]
    yiq = torch.stack([yiq[..., 0], i2, q2], dim=-1)
    x = torch.clamp(torch.einsum("fhwd,cd->fhwc", yiq, yiq2rgb), 0, 255)
    return (x.reshape(n, t, h, w, 3) / 255.0 - mean) / std
