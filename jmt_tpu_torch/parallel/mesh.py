"""Data parallelism across processes: one rank per card.

Counterpart of ``jmt_tpu/parallel/mesh.py``. JAX runs one controller per
host over a mesh of its devices, and GSPMD splits the global batch over
the ``data`` axis. The torch idiom is one process per card, so here a
device of the data mesh is a rank of the default process group:

* ``init_distributed`` joins the group that ``torch.distributed.run``
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``); without them the run is one process and nothing here
  communicates;
* ``make_mesh`` is the world size; ``mesh_dcn`` > 1 is the same flat
  group of ``n_dcn x n_data`` ranks (the batch is split over both axes
  jointly, as in JAX; NCCL builds its own rings);
* the global batch is the ranks' row blocks in rank order
  (``process_rows``); ``gather_rows`` gives every rank the whole of it.

Every collective is an all-reduce, the one collective that NCCL and gloo
both run on CUDA and CPU tensors: a gather is the all-reduce of a
zero-padded buffer, exact (but for the sign of a zero) since each
element has one nonzero term. ``all_gather_rows`` is differentiable; its
backward is the all-reduce of the gradient (the adjoint of a sum over
ranks), so a loss that every rank computes in full comes out of the
backward ``world`` times, and the train step averages the ranks'
gradients (``train/loops.make_train_step``).
"""
from __future__ import annotations

import datetime
import os
import socket
import sys
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def proc_info():
    """(rank, world size); (0, 1) outside a process group. Module-level
    so that tests can stand in for several processes."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """Rank 0 alone writes checkpoints and artifacts."""
    return proc_info()[0] == 0


def host_shard():
    """(rank, world size), for ``PrefetchLoader(host_shard=...)``."""
    return proc_info()


def choose_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when each local rank has a card of its own; ``gloo`` on
    the CPU, and when ranks share a card (NCCL refuses two ranks on one
    device)."""
    if device.type != "cuda":
        return "gloo"
    if torch.cuda.device_count() < local_world:
        return "gloo"
    return "nccl"


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else the card
    ``LOCAL_RANK`` modulo the cards (ranks share cards when there are
    fewer); ``cuda`` on a host without one (which the entry points then
    refuse, as without a group)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        return torch.device("cuda")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout: Optional[float] = None) -> Optional[str]:
    """Join the process group of a ``torch.distributed.run`` launch and
    return its backend; None (and nothing done) without ``RANK`` and
    ``WORLD_SIZE`` in the environment. ``device``: the rank's device
    (default ``local_device()``, made current), which picks the backend
    (``choose_backend``) unless ``backend`` is given. ``timeout``:
    seconds a collective may wait (torch's default when None)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = local_device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dev)
    backend = backend or choose_backend(dev, local_world)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    # the group answers now rather than at the first step's collective
    # (NCCL builds its communicator here, even for one rank)
    probe = _comm(torch.ones(1))
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"the process group's all-reduce gave "
                           f"{probe.item()}, not {world}")
    print(f"jmt_tpu_torch: rank {rank} of {world}, backend {backend}, "
          f"device {dev}", file=sys.stderr, flush=True)
    return backend


def make_mesh(n_data: int = -1, n_dcn: int = 1) -> int:
    """The data mesh's size, which is the world's: ``n_dcn x n_data``
    ranks, ``n_data = -1`` all of them. Raises unless the launch started
    exactly that many processes."""
    _, world = proc_info()
    n_dcn = max(int(n_dcn), 1)
    if n_data == -1:
        n_data = world // n_dcn
    size = n_dcn * n_data
    if n_data < 1 or size != world:
        raise ValueError(
            f"a data mesh of {n_dcn} x {n_data} ranks needs as many "
            f"processes; this run has {world}: launch one process per "
            f"card with python -m torch.distributed.run "
            f"--nproc_per_node={max(size, 1)} -m jmt_tpu_torch.cli ...")
    return size


def process_rows(n_rows: int) -> slice:
    """This rank's contiguous row block of a global batch of ``n_rows``
    rows (the global batch is the blocks in rank order)."""
    idx, count = proc_info()
    if n_rows % count:
        raise ValueError(f"{n_rows} rows do not split over {count} ranks")
    per = n_rows // count
    return slice(idx * per, (idx + 1) * per)


def _comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend takes it: NCCL on the current card; gloo
    where it lies (CPU or CUDA)."""
    if dist.get_backend() == "nccl" and not t.is_cuda:
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the gradient over ranks."""

    @staticmethod
    def forward(ctx, x):
        ctx.device = x.device
        y = _comm(x.contiguous().clone())
        dist.all_reduce(y)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g):
        g = _comm(g.contiguous().clone())
        dist.all_reduce(g)
        return g.to(ctx.device)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated on the
    leading axis in rank order, on every rank; differentiable, exact up
    to the sign of a zero (the all-reduce of a zero-padded buffer, in f32
    for 16-bit floats)."""
    rank, world = proc_info()
    if world == 1:
        return x
    wide = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    buf = torch.stack([wide if r == rank else torch.zeros_like(wide)
                       for r in range(world)])
    out = _AllReduceSum.apply(buf).to(x.dtype)
    return out.reshape(world * x.shape[0], *x.shape[1:])


def average_gradients(params) -> None:
    """Replace each gradient by its mean over the ranks: one all-reduce
    of the gradients flattened. Parameters without a gradient (the same
    on every rank: the graphs are alike) are left out, as one process's
    optimizer skips them."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _comm(torch.cat([g.reshape(-1).float() for g in grads]))
    dist.all_reduce(flat)
    flat /= proc_info()[1]
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def gather_rows(x) -> np.ndarray:
    """Every rank's rows of ``x`` (a tensor or array, this rank's block)
    as one host array in rank order, on every rank: epoch metrics and
    stitching need the whole batch."""
    if proc_info()[1] == 1:
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu() if x.is_floating_point() \
                else x.detach().cpu()
        return np.asarray(x)
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    with torch.no_grad():
        out = all_gather_rows(t.float() if t.is_floating_point() else t)
    return out.cpu().numpy()


def all_agree(values) -> np.ndarray:
    """Each rank's small integer vector ``values``, stacked in rank order
    (rows), on every rank."""
    t = torch.as_tensor(np.asarray(values, np.int64)).reshape(1, -1)
    return gather_rows(t)


def pad_batch_to(arrays: Dict[str, np.ndarray], batch: int):
    """Zero-pad every array's leading axis to ``batch``; returns
    ``(arrays, n_real)``."""
    def pad(x):
        n = x.shape[0]
        if n == batch:
            return x
        return np.pad(x, [(0, batch - n)] + [(0, 0)] * (x.ndim - 1))

    n_real = next(iter(arrays.values())).shape[0]
    return {k: pad(np.asarray(v)) for k, v in arrays.items()}, n_real


def shard_batch(arrays: Dict[str, np.ndarray], device,
                distributed_load: bool = False,
                n_rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Host arrays -> this rank's rows on ``device``. ``distributed_load``:
    the arrays are this rank's rows already (a host-sharded loader);
    otherwise they are the global batch of ``n_rows`` rows (default their
    length), loaded alike on every rank, and the rank keeps its block
    (``process_rows``)."""
    _, count = proc_info()
    if count > 1 and not distributed_load:
        n = n_rows or next(iter(arrays.values())).shape[0]
        rows = process_rows(n)
        arrays = {k: v[rows] for k, v in arrays.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _rank_main(fn, rank: int, world: int, port: int, device, backend,
               timeout: float, out, args) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        init_distributed(backend, device, timeout)
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args, device=None,
                backend: Optional[str] = None, timeout: float = 600.0
                ) -> List:
    """Run ``fn(rank, *args)`` on ``world`` new local processes joined in
    a process group (``init_distributed`` with ``device`` and
    ``backend``) and return their results in rank order. ``fn`` and its
    results must pickle. A rank that raises, or a run past ``timeout``
    seconds, ends every rank and raises here."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, device, backend, timeout,
                               out, args)) for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, object] = {}
    try:
        while len(results) < world:
            rank, ok, value = out.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
