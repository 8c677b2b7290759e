"""Rank functions for the port's multi-process tests (no JAX here).

``tests/test_torch_parallel.py``, ``test_torch_multihost.py`` run these
on gloo ranks of the CPU through ``jmt_tpu_torch.parallel.mesh.
spawn_ranks``, which imports this module in each new process; it keeps
the ranks free of JAX and of the tests' fixtures. Each function returns
numpy values (they pickle).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from jmt_tpu_torch.core import preempt
from jmt_tpu_torch.parallel import mesh as M


def collectives(rank: int) -> dict:
    """The collectives' contracts on this rank (the test compares)."""
    torch.set_num_threads(1)
    _, world = M.proc_info()
    out = {"proc_info": M.proc_info()}
    out["gather"] = M.gather_rows(np.full((2, 3), rank, np.int64))
    bf = torch.tensor([[1.0 + 2 ** -7 * (rank + 1), -0.0]],
                      dtype=torch.bfloat16)
    out["gather_bf16"] = M.all_gather_rows(bf).view(torch.int16).numpy()
    x = torch.tensor([rank + 1.0], requires_grad=True)
    y = M.all_gather_rows(x)
    (y ** 2).sum().backward()
    out["gathered"] = y.detach().numpy()
    out["gather_grad"] = x.grad.numpy()
    out["agree"] = M.all_agree([rank, 7])
    preempt.clear()
    out["agreed_none"] = preempt.agreed()
    if rank == world - 1:
        preempt.request()
    out["agreed_last"] = preempt.agreed()
    out["requested"] = preempt.requested()
    preempt.clear()
    out["rows"] = M.process_rows(8)
    return out


def _model(case: dict):
    from jmt_tpu_torch.core.config import Config, ModelParams, OptimParams
    from jmt_tpu_torch.models import convert
    from jmt_tpu_torch.models.jmt_model import JMTModel
    from jmt_tpu_torch.train import loops
    finetune = case["finetune"]
    names = {"R2D1": "freeze_vision_R2D1",
             "ResNet18": "freeze_audio_ResNet18"}
    # a config lists an audio backbone; for a model without one, the flags
    # of one it does not have freeze nothing
    mp = dict(l_vision_backbones=list(case["model"]["vision_backbones"]),
              l_audio_backbones=list(case["model"]["audio_backbones"]
                                     or ("ResNet18",)),
              intra_modal_fusion=case["model"].get("intra_modal_fusion",
                                                   "None"),
              **{flag: name not in finetune for name, flag in names.items()})
    cfg = Config(model_params=ModelParams(**mp,
                                          opt=OptimParams(**case["opt"])))
    model = JMTModel(**case["model"], finetune=finetune)
    state = loops.init_state(
        model, cfg, device="cpu",
        variables_hook=lambda m: convert.load_jax_variables(
            m, case["variables"]))
    return model, state


def train_step(rank: int, case: dict) -> dict:
    """One port train step on this rank's rows of ``case["arrays"]``
    (``case["factors"]``: the global colour factors); returns the loss,
    the trainable tensors' updates and the BN buffers. With
    ``case["local_bn"]`` also the running statistics that per-rank BN
    would keep (a train-mode forward of a copy on the rank's rows alone,
    as plain DDP runs it)."""
    import copy
    from jmt_tpu_torch.train import loops
    torch.set_num_threads(1)
    model, state = _model(case)
    rows = M.process_rows(case["arrays"]["labels_v"].shape[0])
    s = case["arrays"]["labels_v"].shape[1]
    mine = {k: v[rows] for k, v in case["arrays"].items()}
    factors = tuple(torch.from_numpy(f[rows.start * s:rows.stop * s])
                    for f in case["factors"])
    out = {}
    if case.get("local_bn"):
        local = copy.deepcopy(model)
        local.train()
        with torch.no_grad():
            x = {k: torch.from_numpy(v) for k, v in mine.items()}
            spec, clips = loops.preprocess(local, x, factors)
            local(spec, clips, x.get("wavlm"))
        out["local_stats"] = {k: v.numpy() for k, v in
                              local.state_dict().items()
                              if k.endswith(("running_mean",
                                             "running_var"))}
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = loops.make_train_step(model, device="cpu")
    loss, v, a = step(state, mine, color_factors=factors)
    after = model.state_dict()
    out.update(loss=float(loss), vouts=v.numpy(), aouts=a.numpy(),
               updates={n: (after[n] - before[n]).numpy()
                        for n in state.trainable},
               buffers={k: v.numpy() for k, v in after.items()
                        if not v.is_floating_point()
                        or k.endswith(("running_mean", "running_var"))},
               frozen_same=all(torch.equal(after[n], before[n])
                               for n in state.frozen))
    return out


def fit(rank: int, cfg_dict: dict, outd: str, synthetic: tuple,
        preempt_on: int = -1) -> dict:
    """``Runner.fit`` of ``cfg_dict`` on the synthetic source, this rank's
    experiment under ``outd/rank<r>`` (as per-host directories are);
    ``preempt_on``: the rank that alone is signalled before the fit.
    Returns the perfs, the files under this rank's root, the train steps
    of the last epoch and the final weights."""
    from jmt_tpu_torch.core.config import Config
    from jmt_tpu_torch.core.logging import init_logger
    from jmt_tpu_torch.data.synthetic import synthetic_dataset
    from jmt_tpu_torch.train.runner import Runner
    torch.set_num_threads(1)
    root = os.path.join(outd, f"rank{rank}")
    cfg = Config.from_dict(dict(cfg_dict, outd=root))
    init_logger(None, stdout=False)
    n, length, img = synthetic
    train, val = (synthetic_dataset(split, n_videos=n, length=length,
                                    stride=getattr(cfg, f"{split}_params")
                                    .stride, img_size=img,
                                    check_coverage=False)
                  for split in ("train", "val"))
    runner = Runner(cfg, train, val, device="cpu")
    if rank == preempt_on:
        preempt.request()
    try:
        perfs = runner.fit()
    finally:
        preempt.clear()
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs) \
        if os.path.isdir(root) else []
    return {"perfs": perfs, "files": files,
            "steps": runner.last_timing.get("steps"),
            "weights": {k: v.numpy().copy() for k, v in
                        runner.model.state_dict().items()}}
