"""Plain reference of the frozen-backbone train step.

One step: the colour-augmented clips and the log-mel through the frozen
backbones (eval BN, no gradient), the fusion and heads with gradients,
the loss ccc(V) + ccc(A) over the flattened (B*S) outputs with the row
weights masking padding rows (1 - CCC with the sample standard
deviation, eps 1e-8 in the correlation), and torch's SGD update: ``d = g
+ weight_decay * p``; the momentum buffer ``d`` at the first step, else
``momentum * buf + (1 - dampening) * d``; with Nesterov ``d += momentum *
buf``; ``p -= lr * d``. A tensor that gets no gradient is not updated.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from bench_h100.reference import jmt


def ccc_loss(pred: torch.Tensor, target: torch.Tensor,
             weight: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x, y, w = pred.reshape(-1), target.reshape(-1), weight.reshape(-1)
    n = w.sum()
    x_m, y_m = (x * w).sum() / n, (y * w).sum() / n
    vx, vy = (x - x_m) * w, (y - y_m) * w
    sxx, syy = (vx ** 2).sum(), (vy ** 2).sum()
    rho = (vx * vy).sum() / (torch.sqrt(sxx) * torch.sqrt(syy) + eps)
    x_s, y_s = torch.sqrt(sxx / (n - 1)), torch.sqrt(syy / (n - 1))
    ccc = 2 * rho * x_s * y_s / (x_s ** 2 + y_s ** 2 + (x_m - y_m) ** 2)
    return 1.0 - ccc


def follow(ops: jmt.Ops, w: Dict[str, torch.Tensor], model: dict,
           optimizer: dict, batches: Sequence[Dict[str, torch.Tensor]],
           block: int = 32, fold: bool = False) -> Dict:
    """SGD steps from the weights ``w`` over ``batches``. Returns each
    step's loss and (V, A) outputs, the first step's gradients and
    momentum buffers, and the trainable tensors after the last step."""
    lr, mom = optimizer["lr"], optimizer["momentum"]
    damp, wd = optimizer["dampening"], optimizer["weight_decay"]
    params = {n: w[n].clone().requires_grad_(True) for n in w
              if jmt.trainable(n)}
    bufs: Dict[str, torch.Tensor] = {}
    out = {"losses": [], "outputs": []}
    for step, b in enumerate(batches):
        with torch.no_grad():
            feats = jmt.forward_features(
                ops, w, model, b["clips"], b["audio"],
                (b["brightness"], b["contrast"]), fold, block)
        v, a = jmt.fusion(ops, dict(w, **params), model, feats,
                          b["wavlm"].float())
        rw = b["row_weight"][:, None].expand(v.shape)
        loss = (ccc_loss(v, b["labels_v"], rw)
                + ccc_loss(a, b["labels_a"], rw))
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        out["losses"].append(float(loss.detach()))
        out["outputs"].append((v.detach(), a.detach()))
        with torch.no_grad():
            if step == 0:
                out["first_grads"] = {n: g.detach().clone() for n, g in
                                      zip(names, grads) if g is not None}
            for n, g in zip(names, grads):
                if g is None:
                    continue
                p = params[n]
                d = g + wd * p if wd else g.clone()
                if n not in bufs:
                    bufs[n] = d.clone()
                else:
                    bufs[n].mul_(mom).add_(d, alpha=1 - damp)
                if optimizer["nesterov"]:
                    d = d + mom * bufs[n]
                else:
                    d = bufs[n]
                p.sub_(lr * d)
            if step == 0:
                out["first_buffers"] = {n: t.clone() for n, t in bufs.items()}
    out["params"] = {n: p.detach() for n, p in params.items()}
    return out
