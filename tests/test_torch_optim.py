"""The port's optimizers and schedules against the JAX package.

Three steps of ``build_optimizer`` (SGD with Nesterov momentum and weight
decay; Adam; AMSGrad) on one random parameter tree against ``jmt_tpu``'s
optax chain on the same gradients, atol 1e-7 on the updated parameters
(their magnitudes stay below 0.5). Adam and AMSGrad differ from optax by
up to 2.1e-7 there: optax rounds the bias correction 1 - 0.999^t to
float32 (1.3e-5 relative at t = 1), torch and the port keep it in double.
They are held to the optax chain at 5e-7 and to a float64 evaluation of
the same update rule at 1e-7. Every ``lr_schedule`` over epochs 0-60,
fresh and resumed (``last_epoch`` -1 and 3), equal as floats;
``ReduceLROnPlateau`` over one loss sequence, equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from jmt_tpu.core.config import OptimParams as JOptimParams
from jmt_tpu.train import optim as jopt
from jmt_tpu_torch.core.config import OptimParams
from jmt_tpu_torch.train import optim

SHAPES = {"w": (6, 5), "b": (5,), "scale": (3, 2, 4)}

OPTIMIZERS = {
    "sgd_nesterov": dict(name_optimizer="sgd", lr=1e-2, momentum=0.9,
                         weight_decay=1e-4, nesterov=True),
    "sgd_plain": dict(name_optimizer="sgd", lr=5e-2, momentum=0.0,
                      weight_decay=1e-3, nesterov=True),
    "adam": dict(name_optimizer="adam", lr=1e-2, weight_decay=1e-4),
    "amsgrad": dict(name_optimizer="adam", lr=1e-2, weight_decay=1e-4,
                    amsgrad=True),
}


def _adam_f64(p0, grads, kw):
    """The JAX package's Adam / AMSGrad update in float64: L2 decay in the
    gradient, the AMSGrad max over the bias-corrected second moment."""
    b1, b2, eps, lr, wd = 0.9, 0.999, 1e-8, kw["lr"], kw["weight_decay"]
    out = {}
    for k, p in p0.items():
        p = p.astype(np.float64)
        mu = np.zeros_like(p)
        nu = np.zeros_like(p)
        nu_max = np.zeros_like(p)
        for t, g in enumerate(grads, start=1):
            g = g[k] + wd * p
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * g * g + b2 * nu
            nu_hat = nu / (1 - b2 ** t)
            nu_max = np.maximum(nu_max, nu_hat) if kw.get("amsgrad") \
                else nu_hat
            p = p - lr * (mu / (1 - b1 ** t)) / (np.sqrt(nu_max) + eps)
        out[k] = p
    return out


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_match_jax_optax_chain(name):
    kw = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    p0 = {k: rng.uniform(-0.4, 0.4, s).astype(np.float32)
          for k, s in SHAPES.items()}
    # the AMSGrad case shrinks its gradients so that nu_max keeps an
    # earlier step's value, where the two maxima differ
    scales = (1.0, 0.1, 1.0) if name == "amsgrad" else (1.0, 1.0, 1.0)
    grads = [{k: (c * rng.normal(size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for c in scales]

    tx = jopt.build_optimizer(JOptimParams(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = optim.build_optimizer(OptimParams(**kw), tp.values())
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    adam = kw["name_optimizer"] == "adam"
    exact = _adam_f64(p0, grads, kw) if adam else None
    for k in SHAPES:
        moved = np.abs(np.asarray(jp[k]) - p0[k]).max()
        assert moved > 1e-4
        got = tp[k].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jp[k]), rtol=0,
                                   atol=5e-7 if adam else 1e-7)
        if adam:
            np.testing.assert_allclose(got, exact[k], rtol=0, atol=1e-7)


def test_amsgrad_takes_the_max_of_the_bias_corrected_moment():
    """torch's own AMSGrad (max of the raw moment) would differ here."""
    kw = OPTIMIZERS["amsgrad"]
    w = torch.nn.Parameter(torch.zeros(1))
    ours = optim.build_optimizer(OptimParams(**kw), [w])
    assert isinstance(ours, optim.AMSGrad)
    w2 = torch.nn.Parameter(torch.zeros(1))
    theirs = torch.optim.Adam([w2], lr=kw["lr"],
                              weight_decay=kw["weight_decay"], amsgrad=True)
    for g in (1.0, 0.01, 0.01):
        for p, o in ((w, ours), (w2, theirs)):
            p.grad = torch.tensor([g])
            o.step()
    assert abs(w.item() - w2.item()) > 1e-4


def test_set_learning_rate_writes_every_group():
    a, b = (torch.nn.Parameter(torch.zeros(2)) for _ in range(2))
    opt = torch.optim.SGD([{"params": [a]}, {"params": [b], "lr": 3.0}],
                          lr=1.0)
    optim.set_learning_rate(opt, 0.25)
    assert [g["lr"] for g in opt.param_groups] == [0.25, 0.25]


@pytest.mark.parametrize("last_epoch", [-1, 3])
@pytest.mark.parametrize("scheduler", ["step", "mystep", "cosine",
                                       "mycosine", "multistep",
                                       "reduce_on_plateau", None])
def test_lr_schedule_matches_jax(scheduler, last_epoch):
    kw = dict(lr=0.1, step_size=7, gamma=0.5, min_lr=1e-3, t_max=25,
              milestones=[5, 12, 40], last_epoch=last_epoch, max_epochs=30)
    if scheduler is None:
        kw["lr_scheduler"] = False
    else:
        kw["name_lr_scheduler"] = scheduler
    got = optim.lr_schedule(OptimParams(**kw))
    want = jopt.lr_schedule(JOptimParams(**kw))
    assert [got(e) for e in range(61)] == [want(e) for e in range(61)]


def test_reduce_on_plateau_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.8, 0.85, 0.86, 0.9,
              0.91, 0.92, 0.93, 0.7, 0.71, 0.72, 0.73, 0.74, 0.75, 0.76]
    for mode in ("min", "max"):
        kw = dict(lr=0.1, mode=mode, factor=0.5, patience=2, min_lr=0.02,
                  name_lr_scheduler="reduce_on_plateau")
        got = optim.ReduceLROnPlateau(OptimParams(**kw))
        want = jopt.ReduceLROnPlateau(JOptimParams(**kw))
        seq = [(got.step(x), want.step(x)) for x in losses]
        assert [a for a, _ in seq] == [b for _, b in seq]
        assert len({a for a, _ in seq}) > 1
