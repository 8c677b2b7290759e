"""Optimizers and epoch-level learning-rate schedules with torch semantics.

Counterpart of ``jmt_tpu/train/optim.py``. The JAX package emulates
``torch.optim.SGD`` (its ``torch_sgd``) and torch's Adam with L2 weight
decay coupled into the gradient; here those are torch's own classes
(``tests/test_torch_optim.py`` holds them to the JAX chains). AMSGrad is
the exception: optax's ``scale_by_amsgrad`` takes its running maximum over
the bias-corrected second moment, torch's over the raw one, so ``AMSGrad``
below writes the JAX package's update itself.

Schedules are functions ``lr(epoch) -> float`` that the loop evaluates once
an epoch and writes into the optimizer (``set_learning_rate``); the plateau
schedule is a small stateful class, stepped with the epoch loss.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from jmt_tpu_torch.core.config import OptimParams


class AMSGrad(torch.optim.Optimizer):
    """Adam with AMSGrad as optax computes it, L2 decay in the gradient:

        g = grad + weight_decay * p
        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        nu_max = max(nu_max, nu / (1 - b2^t))
        p -= lr * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)
    """

    def __init__(self, params: Iterable, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for name in ("mu", "nu", "nu_max"):
                        state[name] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
                nu = state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                nu_max = torch.maximum(state["nu_max"], nu / (1 - b2 ** t),
                                       out=state["nu_max"])
                p.sub_(group["lr"] * (mu / (1 - b1 ** t))
                       / (torch.sqrt(nu_max) + group["eps"]))
        return loss


def build_optimizer(opt: OptimParams, params: Iterable
                    ) -> torch.optim.Optimizer:
    """SGD or Adam (the reference's optimizer factory) over ``params``,
    at the initial learning rate ``opt.lr``."""
    params = list(params)
    if opt.name_optimizer == "sgd":
        # with no momentum, nesterov changes nothing (and torch refuses it)
        return torch.optim.SGD(
            params, lr=opt.lr, momentum=opt.momentum,
            dampening=opt.dampening, weight_decay=opt.weight_decay,
            nesterov=opt.nesterov and opt.momentum != 0.0)
    if opt.name_optimizer == "adam":
        kw = dict(lr=opt.lr, betas=(opt.beta1, opt.beta2), eps=opt.eps_adam,
                  weight_decay=opt.weight_decay)
        return AMSGrad(params, **kw) if opt.amsgrad else \
            torch.optim.Adam(params, **kw)
    raise ValueError(opt.name_optimizer)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float
                      ) -> torch.optim.Optimizer:
    """Write the epoch's learning rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def lr_schedule(opt: OptimParams) -> Callable[[int], float]:
    """The learning rate of training epoch e (0-based).

    ``last_epoch`` resume: torch's step-family schedulers resume from the
    optimizer's current lr, so training epoch e sits at absolute epoch
    e + N + 1 and only the decay boundaries in (N, e + N + 1] apply. The
    cosine family takes its closed form at the shifted epoch.
    """
    base = opt.lr
    name = opt.name_lr_scheduler
    if not opt.lr_scheduler:
        return lambda epoch: base
    n_last = int(opt.last_epoch)
    off = n_last + 1

    def steps(e):  # decay boundaries passed since the resume point
        return (e + off) // opt.step_size - max(n_last, 0) // opt.step_size

    if name == "step":
        return lambda e: base * opt.gamma ** steps(e)
    if name == "mystep":  # floored at min_lr
        return lambda e: max(base * opt.gamma ** steps(e), opt.min_lr)
    if name == "cosine":  # CosineAnnealingLR's closed form
        return lambda e: opt.min_lr + (base - opt.min_lr) * (
            1 + math.cos(math.pi * (e + off) / opt.t_max)) / 2
    if name == "mycosine":
        max_epochs = float(opt.max_epochs)
        return lambda e: max(
            base * opt.coef * (1.0 + math.cos((e + off - 1) * math.pi
                                              / max_epochs)),
            opt.min_lr)
    if name == "multistep":
        ms = sorted(opt.milestones)

        def n_hit(x):  # milestones at or before absolute epoch x
            return sum(1 for m in ms if x >= m)

        return lambda e: base * opt.gamma ** (n_hit(e + off) - n_hit(n_last))
    if name == "reduce_on_plateau":  # ReduceLROnPlateau sets the lr
        return lambda e: base
    raise ValueError(name)


class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau (mode, factor, patience, min_lr; no
    threshold), stepped once an epoch with the epoch loss."""

    def __init__(self, opt: OptimParams):
        self.lr = opt.lr
        self.mode = opt.mode
        self.factor = opt.factor
        self.patience = opt.patience
        self.min_lr = opt.min_lr
        self.best: Optional[float] = None
        self.num_bad = 0

    def step(self, metric: float) -> float:
        better = (self.best is None
                  or (self.mode == "min" and metric < self.best)
                  or (self.mode == "max" and metric > self.best))
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
