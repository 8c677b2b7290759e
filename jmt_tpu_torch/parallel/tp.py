"""Tensor-parallel serving: output channels split over devices.

Counterpart of ``jmt_tpu/parallel/tp.py``. Data parallelism (``mesh``)
scales throughput; it cannot shorten one request. Tensor parallelism
splits the output channels of the conv and dense layers over a ``model``
mesh of devices. JAX annotates the parameter tree and lets GSPMD
propagate the shardings; here one process drives every shard, as JAX's
single controller does:

* the rule is JAX's: a conv or dense weight whose output-channel axis
  (dim 0 in torch layout) is at least ``min_dim`` (128) and divisible by
  the mesh is split on it (``tp_shardings``); every other weight stays
  whole. A conv that computes aligned channels (``ops/conv.py``'s note)
  is split on its padded count, zero channels included;
* under ``tensor_parallel(mesh)`` each such layer (``ops/conv.conv_nd``
  and ``linear``, the funnels that every backbone conv and every dense
  layer of the port goes through) computes its i-th output-channel slice
  on device i from the replicated input, and the slices are gathered on
  the lead device (``mesh[0]``), where BN and the activation then run
  whole;
* the hand-written kernels run on the lead device on whole operands (K1
  in the preprocessing, K3 the fused inception module, K2 the attention
  core, which has no weights), as GSPMD replicates a custom call;
* an int8 conv (``ops/quant.py``) that the rule splits quantizes x once
  on the lead (K6: one per-tensor scale, as JAX's replicated quantize),
  and each device runs K5 on its slice of the weight, prepared per slice;
  K5's exact s32 sums and per-channel dequantize make the gathered slices
  the whole conv's columns bit for bit.

The model lives on the lead device; each forward copies the other
devices' weight slices to them (no copy where a device is the lead, as
when one card appears several times in the mesh). The result equals the
unsharded forward up to the choice of conv and GEMM algorithm for the
narrower problems. ``sharded_calls()`` counts the split layers run.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

_ACTIVE = threading.local()
_CALLS = {"n": 0}


def make_model_mesh(n_model: int = -1,
                    devices: Optional[Sequence] = None
                    ) -> List[torch.device]:
    """The ``model`` mesh: the first ``n_model`` of ``devices`` (default
    every card; -1 all of them), in order, the first the lead. A device
    may appear more than once."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_model == -1:
        n_model = len(devices)
    if not 1 <= n_model <= len(devices):
        raise ValueError(f"a model mesh of {n_model} devices; "
                         f"{len(devices)} are there")
    return devices[:n_model]


def _eligible(out_dim: int, n_model: int, min_dim: int) -> bool:
    return n_model > 1 and out_dim >= min_dim and out_dim % n_model == 0


def tp_shardings(model: torch.nn.Module, mesh: Sequence,
                 min_dim: int = 128) -> Dict[str, int]:
    """Each parameter's shard count: ``len(mesh)`` for a conv or dense
    weight (ndim >= 2) that the rule splits on dim 0, 1 (whole) for every
    other parameter."""
    n = len(mesh)
    return {name: n if p.ndim >= 2 and _eligible(p.shape[0], n, min_dim)
            else 1 for name, p in model.named_parameters()}


def shard_params(model: torch.nn.Module, mesh: Sequence,
                 min_dim: int = 128) -> Dict[str, int]:
    """Put the model on the lead device; returns ``tp_shardings``. The
    split itself happens at forward time, under ``tensor_parallel``."""
    model.to(torch.device(mesh[0]))
    return tp_shardings(model, mesh, min_dim)


def replicate(tree: Dict[str, torch.Tensor], mesh: Sequence
              ) -> Dict[str, torch.Tensor]:
    """A request's tensors on the lead device: every split layer copies
    its input to the other devices of the mesh."""
    lead = torch.device(mesh[0])
    return {k: torch.as_tensor(v).to(lead) for k, v in tree.items()}


@contextlib.contextmanager
def tensor_parallel(mesh: Optional[Sequence], min_dim: int = 128
                    ) -> Iterator[None]:
    """Layers within split their output channels over ``mesh`` (None: as
    they are)."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = (None if mesh is None
                    else ([torch.device(d) for d in mesh], min_dim))
    try:
        yield
    finally:
        _ACTIVE.mesh = prev


def sharded_calls() -> int:
    """Split layers run so far (all meshes, this process)."""
    return _CALLS["n"]


def split_devices(out_dim: int) -> Optional[List[torch.device]]:
    """The mesh's devices, lead first, when a layer of ``out_dim`` output
    channels splits under the active ``tensor_parallel``; else None."""
    active = getattr(_ACTIVE, "mesh", None)
    if active is None:
        return None
    devices, min_dim = active
    return devices if _eligible(out_dim, len(devices), min_dim) else None


def gather(outs: Sequence[torch.Tensor], dim: int = 1) -> torch.Tensor:
    """Output-channel slices, slice i from device i, concatenated on the
    lead device (the first slice's); counts one split layer."""
    lead = outs[0].device
    _CALLS["n"] += 1
    return torch.cat([o.to(lead) for o in outs], dim=dim)


def split_output(fn, x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, dim: int = 1
                 ) -> torch.Tensor:
    """``fn(x, weight[, bias])``, whose output channels (``dim`` of the
    result) are ``weight``'s dim 0: under ``tensor_parallel`` and for a
    weight the rule splits, slice i on device i, gathered on the lead."""
    args = () if bias is None else (bias,)
    devices = split_devices(weight.shape[0])
    if devices is None:
        return fn(x, weight, *args)
    n = len(devices)
    ws = weight.chunk(n, 0)
    bs = bias.chunk(n, 0) if bias is not None else (None,) * n
    outs = []
    for dev, w, b in zip(devices, ws, bs):
        extra = () if b is None else (b.to(dev),)
        outs.append(fn(x.to(dev), w.to(dev), *extra))
    return gather(outs, dim)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear``, its output features split under
    ``tensor_parallel``."""
    return split_output(F.linear, x, weight, bias, dim=-1)
