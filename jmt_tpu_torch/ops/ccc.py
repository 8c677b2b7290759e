"""Concordance Correlation Coefficient: the training loss and the eval metric.

Counterpart of ``jmt_tpu/ops/ccc.py``. The two reference implementations
differ on purpose, and each is kept:

* ``ccc_loss``: the training criterion (the reference's ``CCCLoss`` with
  digitize_num=1): **sample** std (n - 1), eps = 1e-8 in the rho
  denominator only, and NO masking of the -5.0 padding labels; they enter
  the loss, a reference quirk. ``weight`` ({0, 1} per element) drops
  static-batch padding rows.
* ``ccc_metric``: the eval metric: **population** std (n), no eps.
* ``ccc_loss_masked``: 1 - CCC over the entries whose label is not -5.0.
* ``ccc_loss_digitized``: the loss on the expectation of a softmax over
  ``num_bins`` bins (digitize_num > 1).

All take tensors of any shape and flatten them; they compute in the
inputs' dtype with torch's type promotion.
"""
from __future__ import annotations

from typing import Optional

import torch


def _ccc(vx: torch.Tensor, vy: torch.Tensor, x_m: torch.Tensor,
         y_m: torch.Tensor, n, eps: float) -> torch.Tensor:
    """CCC from the centred (and masked) vectors, sample std."""
    sxx, syy = torch.sum(vx ** 2), torch.sum(vy ** 2)
    rho = torch.sum(vx * vy) / (torch.sqrt(sxx) * torch.sqrt(syy) + eps)
    x_s = torch.sqrt(sxx / (n - 1))
    y_s = torch.sqrt(syy / (n - 1))
    return 2 * rho * x_s * y_s / (x_s ** 2 + y_s ** 2 + (x_m - y_m) ** 2)


def ccc_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1 - CCC with torch semantics (sample std); ``weight`` masks
    elements out (all ones is the unweighted form)."""
    x = pred.reshape(-1)
    y = target.reshape(-1)
    if weight is None:
        n = torch.tensor(x.shape[0], dtype=x.dtype, device=x.device)
        x_m, y_m = torch.mean(x), torch.mean(y)
        vx, vy = x - x_m, y - y_m
    else:
        w = weight.reshape(-1).to(x.dtype)
        n = torch.sum(w)
        x_m = torch.sum(x * w) / n
        y_m = torch.sum(y * w) / n
        vx, vy = (x - x_m) * w, (y - y_m) * w
    return 1.0 - _ccc(vx, vy, x_m, y_m, n, eps)


def ccc_metric(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """CCC with numpy semantics (population std, no eps); NaN for a
    constant input, as the reference's."""
    x = x.reshape(-1)
    y = y.reshape(-1)
    x_m, y_m = torch.mean(x), torch.mean(y)
    vx, vy = x - x_m, y - y_m
    sxx, syy = torch.sum(vx ** 2), torch.sum(vy ** 2)
    rho = torch.sum(vx * vy) / (torch.sqrt(sxx) * torch.sqrt(syy))
    x_s = torch.std(x, correction=0)
    y_s = torch.std(y, correction=0)
    return 2 * rho * x_s * y_s / (x_s ** 2 + y_s ** 2 + (x_m - y_m) ** 2)


def ccc_loss_masked(pred: torch.Tensor, target: torch.Tensor,
                    ignore: float = -5.0, eps: float = 1e-8) -> torch.Tensor:
    """1 - CCC over the entries whose target != ``ignore`` (at least two
    entries are counted)."""
    x = pred.reshape(-1)
    y = target.reshape(-1)
    w = (y != ignore).to(x.dtype)
    n = torch.clamp(torch.sum(w), min=2.0)
    x_m = torch.sum(x * w) / n
    y_m = torch.sum(y * w) / n
    return 1.0 - _ccc((x - x_m) * w, (y - y_m) * w, x_m, y_m, n, eps)


def digitized_expectation(logits: torch.Tensor, num_bins: int,
                          v_range=(-1.0, 1.0)) -> torch.Tensor:
    """Softmax over ``num_bins`` logits, expectation over evenly spaced
    bins in ``v_range``."""
    bins = torch.linspace(v_range[0], v_range[1], num_bins,
                          dtype=logits.dtype, device=logits.device)
    return torch.sum(bins * torch.softmax(logits, dim=-1), dim=-1)


def ccc_loss_digitized(logits: torch.Tensor, target: torch.Tensor,
                       num_bins: int, eps: float = 1e-8) -> torch.Tensor:
    """1 - CCC on the binned expectation; logits (..., num_bins)."""
    x = digitized_expectation(logits.reshape(-1, num_bins), num_bins)
    return ccc_loss(x, target, eps=eps)
