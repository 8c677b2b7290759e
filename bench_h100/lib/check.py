"""Whether what the timed path produced is correct: the reference's view.

The reference computes at the precision the configuration states
(``stated_ops``: a bf16 configuration's operands, outputs and
activations rounded to bfloat16 where the program holds them, with
float32 accumulation), so that the program's own rounding is not what
the check reads. Served cells: the reference's (V, A) of every distinct
request of the run, at the run's sizes, in blocks of clips; the number
compared is the widest gap between a served answer and the reference's,
over every answer completed in the window, over the mean gap that bf16
rounding itself puts between the reference in bf16 and in float32 on
that seed's answers (``va_gap_rel``).

Train cells: the reference follows the program's first three steps from
the same weights, batches and colour factors, with SGD as torch computes
it (``train_numbers``). Compared: the widest gap of the three steps' (V,
A) outputs (``va_gap``), and the median over leaves of the gap between
the norms of the program's and the reference's change of a leaf after the
three steps, over the larger of the reference's norm of that leaf and of
the median leaf (``update_gap``). Read beside them: the widest gap of the
three losses, the same median gap of the first gradient as the optimizer
gets it (its momentum buffer after one step), and both per-leaf gaps at
their worst leaf. Leaves whose reference gradient is under a thousandth
of the median leaf's (the visual fusion's unused 768 -> 512 fc) move by
round-off alone and are left out by that rule.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench_h100.lib import weights
from bench_h100.reference import jmt
from bench_h100.reference import train as ref_train

BLOCK = 64


def stated_ops(config: Dict, control: bool = False,
               scales: Sequence[float] = None) -> jmt.Ops:
    """The reference's arithmetic at the precision the configuration
    states: bfloat16 compute as ``jmt.Bf16Ops``, float32 as ``jmt.Ops``
    (static int8: ``jmt.Bf16QuantOps``, ``jmt.QuantOps``, calibrating
    while ``scales`` is None). ``control``: the nearest precision below (e4m3
    ``jmt.Fp8Ops``, int4 ``jmt.Int4Ops``; bfloat16 for float32)."""
    if config["int8"] == "static":
        if control:
            return jmt.Int4Ops(scales)
        if config["compute_dtype"] == "bfloat16":
            return jmt.Bf16QuantOps(127, scales)
        return jmt.QuantOps(127, scales)
    if config["compute_dtype"] == "bfloat16":
        return jmt.Fp8Ops() if control else jmt.Bf16Ops()
    return jmt.Bf16Ops() if control else jmt.Ops()


def folds(config: Dict) -> bool:
    """Whether the served model folds a 2x upsample into the I3D stem
    (clips at half the I3D's input size), as the reference then does."""
    return config["model"]["i3d_input_size"] == 2 * config["input"]["size"]


def reference_va(config: Dict, w: Dict[str, torch.Tensor], device,
                 requests: Sequence[Dict[str, torch.Tensor]],
                 calibration: Dict[str, torch.Tensor] = None,
                 control: bool = False
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(V, A) of each request at the configuration's stated precision
    (``stated_ops``; TF32 off), a static int8 configuration's scales
    calibrated by the reference itself on ``calibration``. ``control``:
    in the nearest precision below."""
    model = config["model"]
    w = weights.to(w, device)
    fold = folds(config)
    with jmt.no_tf32(), torch.inference_mode():
        ops = stated_ops(config, control)
        if config["int8"] == "static":
            jmt.forward(ops, w, model, calibration["clips"],
                        calibration["audio"], calibration["wavlm"],
                        fold=fold, block=BLOCK)
            ops = stated_ops(config, control, ops.scales_from_maxes())
        out = []
        for r in requests:
            v, a = jmt.forward(ops, w, model, r["clips"], r["audio"],
                               r["wavlm"], fold=fold, block=BLOCK)
            out.append((v.cpu().numpy(), a.cpu().numpy()))
    return out


def noise_scale(config: Dict, w: Dict[str, torch.Tensor], device,
                requests: Sequence[Dict[str, torch.Tensor]],
                calibration: Dict[str, torch.Tensor] = None) -> float:
    """How far bf16 rounding moves this seed's answers: the mean |V, A
    of the reference in bfloat16 - V, A of the reference in float32|
    over every answer of ``requests`` (the configuration's int8 mode in
    both)."""
    a, b = (reference_va(dict(config, compute_dtype=dt), w, device,
                         requests, calibration)
            for dt in ("bfloat16", "float32"))
    return float(np.mean([np.abs(x - y).mean()
                          for pa, pb in zip(a, b) for x, y in zip(pa, pb)]))


def va_gap(served: Sequence[Tuple[int, np.ndarray, np.ndarray]],
           reference: Sequence[Tuple[np.ndarray, np.ndarray]]) -> float:
    """The widest |served - reference| over every V and A served; a
    served answer of another shape than the reference's is infinitely
    far."""
    gap = 0.0
    for idx, v, a in served:
        rv, ra = reference[idx]
        if v.shape != rv.shape or a.shape != ra.shape:
            return float("inf")
        gap = max(gap, float(np.abs(v - rv).max()), float(np.abs(a - ra).max()))
    return gap if np.isfinite(gap) else float("inf")


def va_gap_rel(served: Sequence[Tuple[int, np.ndarray, np.ndarray]],
               reference: Sequence[Tuple[np.ndarray, np.ndarray]],
               scale: float) -> float:
    """``va_gap`` in units of the seed's ``noise_scale``: the seeds'
    models differ in how far any rounding moves their answers, and this
    divides that out."""
    return va_gap(served, reference) / scale


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> Dict[str, float]:
    """Each leaf of ``keep``: | |prog| - |ref| | / max(|ref|, median |ref|);
    a leaf the program lacks reads as 1."""
    ref_norms = {n: float(ref[n].norm()) for n in keep}
    med = statistics.median(ref_norms.values())
    return {n: abs((float(prog[n].norm()) if n in prog else 0.0)
                   - ref_norms[n]) / max(ref_norms[n], med) for n in keep}


def train_reference(config: Dict, optimizer: Dict,
                    w: Dict[str, torch.Tensor], device,
                    batches: Sequence[Dict[str, torch.Tensor]],
                    steps: int = 3, ops=None) -> Tuple[Dict, Dict]:
    """(the trainable tensors before the first step, the reference's
    ``train.follow`` of the first ``steps`` steps), at the
    configuration's stated precision (``stated_ops``; TF32 off) unless
    ``ops`` says otherwise."""
    model = config["model"]
    w = weights.to(w, device)
    before = {n: w[n].clone() for n in w if jmt.trainable(n)}
    with jmt.no_tf32():
        ref = ref_train.follow(ops or stated_ops(config), w, model,
                               optimizer, batches[:steps], block=BLOCK,
                               fold=folds(config))
    return before, ref


def train_numbers(before: Dict, ref: Dict, losses: Sequence[float],
                  outputs: Sequence, first_buffers: Dict, after: Dict
                  ) -> Dict[str, float]:
    """The train numbers of a run's first steps against the reference's:
    its losses, its (V, A) outputs, its first gradients as the optimizer
    got them and its change of the parameters."""
    grad_norms = {n: float(g.norm()) for n, g in ref["first_grads"].items()}
    med = statistics.median(grad_norms.values())
    keep = [n for n in before if grad_norms.get(n, 0.0) >= 1e-3 * med]
    change = {n: after[n] - before[n] for n in keep if n in after}
    change_ref = {n: ref["params"][n] - before[n] for n in keep}
    grad = leaf_gaps(first_buffers, ref["first_buffers"], keep)
    update = leaf_gaps(change, change_ref, keep)

    def worst(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    va = max(float((torch.as_tensor(p).to(r.device).float() - r).abs().max())
             if tuple(p.shape) == tuple(r.shape) else float("inf")
             for po, ro in zip(outputs, ref["outputs"])
             for p, r in zip(po, ro))
    return {
        "va_gap": va, "update_gap": statistics.median(update.values()),
        "loss_gap": max(abs(a - b) for a, b in zip(losses, ref["losses"])),
        "grad_gap": statistics.median(grad.values()),
        "grad_gap_worst": max(grad.values()),
        "update_gap_worst": max(update.values()),
        "worst": {"grad": worst(grad), "update": worst(update)},
        "leaves_compared": float(len(keep))}
