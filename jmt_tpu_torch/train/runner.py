"""Experiment orchestrator: the reference's main(), on one card or on
several ranks.

Counterpart of ``jmt_tpu/train/runner.py`` ``Runner``: the model and the
datasets of a config, an epoch loop with the reference's per-epoch reseed
(SEED + epoch; SEED again before validation), an epoch of train steps
then stitched validation, the best epoch by the average valid CCC (a CPU
copy of its weights, written to ``SavedWeights/`` at the end or on every
improvement), ``train_state.pt`` after every epoch for resume,
``perfs.yml``, the tracker plot (when matplotlib is there) and
``passed.txt``.

Preemption (``core/preempt``): every ``preempt_save_steps`` train steps
and at the epoch boundaries a requested preemption saves the state and
ends ``fit`` without ``passed.txt``. A mid-epoch save holds the step and
the epoch's accumulators; ``resume`` replays the epoch's data order (a
function of SEED + epoch) and skips the steps already taken. Each step's
colour factors, or the parameters of the heavy augmentations that
``train_params``' ``use_more_vision_data_augm`` /
``use_more_audio_data_augm`` turn on (the train step's only, as in JAX),
come from a generator seeded by (SEED, epoch, step)
(``core/rng.step_generator``), so the resumed run is the uninterrupted
one, bit for bit on the CPU.

A batch smaller than the loader's batch size is padded with zero rows to
it (``pad_batch_to``) and ``row_weight`` masks the pad rows out of the
loss and the epoch metrics.

Each epoch logs, beside the CCCs, its train and validate seconds, the
step p50 (host clock from the batch in hand to the step's loss read,
which waits for the card), the seconds the loop waited on the loader and
their share of the train seconds, the host-to-device copy time (CUDA
events on the card), the seconds the loop spent on checkpoints (the CPU
copies and the wait for the write before; the writes run on a thread)
and the peak memory.
With ``profile_dir``, a ``torch.profiler`` trace of train steps 2-4 of
``profile_epoch`` is written there (by rank 0).

Under a process group (``parallel/mesh``, launched by
``torch.distributed.run``; one rank per card) the runner is JAX's pod
runner: ``batch_size`` stays global and splits over the ranks
(``make_mesh`` checks ``mesh_data_parallel`` against the world); each
rank's train loader takes its stride of the sample order
(``PrefetchLoader(host_shard=...)``) and the train step computes the
global step (``train/loops.make_train_step``); eval loaders read the
whole split on every rank and each rank runs its row block; the epoch
metrics and the stitching gather every rank's rows (``gather_rows``);
the preemption flag is agreed at every boundary (``preempt.agreed``);
``fit`` first checks that every rank resumed the same checkpoint; rank 0
alone writes checkpoints, weights and artifacts, so a resume needs
``weights_dir`` on storage that every rank reads.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from jmt_tpu_torch.core import checkpoint as ckpt
from jmt_tpu_torch.core import preempt
from jmt_tpu_torch.core.config import Config, ExperimentDir
from jmt_tpu_torch.core.logging import get_logger
from jmt_tpu_torch.core.rng import set_global_seed, step_generator
from jmt_tpu_torch.data.loader import PrefetchLoader
from jmt_tpu_torch.data.transforms import sample_color_factors
from jmt_tpu_torch.device import resolve_device
from jmt_tpu_torch.eval.stitch import Stitcher, write_challenge_txt
from jmt_tpu_torch.models.jmt_model import model_from_config
from jmt_tpu_torch.ops.ccc import ccc_metric
from jmt_tpu_torch.parallel import mesh as M
from jmt_tpu_torch.parallel.mesh import pad_batch_to  # noqa: F401
from jmt_tpu_torch.train import optim as O
from jmt_tpu_torch.train.loops import (device_batch, init_state,
                                       make_eval_step, make_train_step)
from jmt_tpu_torch.train.state import param_count


@dataclasses.dataclass
class EpochMetrics:
    train_ccc_v: float = 0.0
    train_ccc_a: float = 0.0
    valid_ccc_v: float = 0.0
    valid_ccc_a: float = 0.0

    @property
    def valid_avg(self) -> float:
        return (self.valid_ccc_v + self.valid_ccc_a) / 2.0


def _ccc(x, y) -> float:
    return float(ccc_metric(torch.from_numpy(np.asarray(x, np.float32)),
                            torch.from_numpy(np.asarray(y, np.float32))))


class Runner:
    def __init__(self, cfg: Config, train_ds, val_ds, wavlm_store=None,
                 test_ds=None, device=None):
        """device: None is the card (raises without one); "cpu" runs the
        plain PyTorch path."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.test_ds = test_ds
        self.wavlm_store = wavlm_store
        self.exp = ExperimentDir(cfg)
        self.log = get_logger()
        self.model = model_from_config(cfg)
        opt = cfg.model_params.opt
        self.lr_fn = O.lr_schedule(opt)
        self.plateau = (O.ReduceLROnPlateau(opt)
                        if opt.lr_scheduler
                        and opt.name_lr_scheduler == "reduce_on_plateau"
                        else None)
        self.train_step = make_train_step(
            self.model,
            more_vision_augm=cfg.train_params.use_more_vision_data_augm,
            more_audio_augm=cfg.train_params.use_more_audio_data_augm,
            device=self.device)
        self.eval_step = make_eval_step(self.model, device=self.device)
        self.state = None
        self.tracker: Dict[str, list] = {"train_v": [], "train_a": [],
                                         "valid_v": [], "valid_a": []}
        self.best = {"avg": -np.inf, "epoch": -1}
        # CPU copy of the best epoch's state dict (the reference
        # deep-copies its state dicts on improvement)
        self._best_snapshot: Optional[Dict[str, torch.Tensor]] = None
        # a mid-epoch preemption's position, for fit() to save
        self._preempted_mid: Optional[dict] = None
        # a restored mid-epoch position, for the next train_epoch
        self._mid_epoch: Optional[dict] = None
        # the train timings of the epoch that train_epoch ran last
        self.last_timing: Dict[str, float] = {}
        # the data mesh (cfg.mesh_data_parallel x cfg.mesh_dcn ranks, the
        # world) and this rank's (index, count): train loaders split the
        # samples over the ranks, eval loaders read the whole split and
        # each rank keeps its row block
        self.mesh = M.make_mesh(cfg.mesh_data_parallel, n_dcn=cfg.mesh_dcn)
        self.procs = M.host_shard()

    # ------------------------------------------------------------------
    def initialize(self) -> None:
        set_global_seed(self.cfg.SEED)

        def pretrained_hook(model):
            """The init_w_* policy (the reference's main.py:218-302,
            tsav.py:35-116): pretrained backbones loaded before the freeze
            partition and the optimizer."""
            from jmt_tpu_torch.models.pretrained import apply_pretrained
            for comp, path in apply_pretrained(self.cfg, model).items():
                self.log.log(f"Loaded pretrained weights [{comp}]: {path}")

        self.state = init_state(self.model, self.cfg,
                                torch.Generator().manual_seed(self.cfg.SEED),
                                variables_hook=pretrained_hook,
                                device=self.device)
        n = self.mesh
        for split in ("train_params", "val_params", "test_params"):
            bsz = getattr(self.cfg, split).loader_params.batch_size
            if bsz % n:
                raise ValueError(
                    f"{split}.loader_params.batch_size={bsz} must be "
                    f"divisible by the {n}-rank data mesh (batch_size is "
                    f"the global batch)")
        self.log.log({
            "trainable_params": param_count(self.model, self.state.trainable),
            "frozen_params": param_count(self.model, self.state.frozen),
            "device": str(self.device), "mesh_devices": n})

    def _device_arrays(self, batch, bsz: int, copies: Optional[list] = None,
                       distributed_load: bool = False):
        """Host batch -> padded arrays with ``row_weight``, this rank's
        rows on the device; returns (arrays, n_real). ``distributed_load``:
        ``batch`` is this rank's share of the global batch (a host-sharded
        train loader), padded to ``bsz / ranks`` rows, and n_real counts
        its real rows; otherwise it is the global batch, read alike on
        every rank, padded to ``bsz``, n_real counts the global batch's
        real rows and the rank keeps its block. With ``copies``, the copy
        is bracketed by CUDA events appended there."""
        _, count = self.procs
        pad_to = bsz // count if distributed_load else bsz
        arrays, n_real = pad_batch_to(device_batch(batch), pad_to)
        if batch.n_valid is not None:  # a lockstep filler batch
            n_real = min(n_real, batch.n_valid)
        w = np.zeros(pad_to, np.float32)
        w[:n_real] = 1.0
        arrays["row_weight"] = w
        on_card = self.device.type == "cuda" and copies is not None
        if on_card:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = M.shard_batch(arrays, self.device, distributed_load, pad_to)
        if on_card:
            events[1].record()
            copies.append(events)
        return out, n_real

    def _color_factors(self, epoch: int, step: int, n_clips: int):
        """Train step ``step`` of ``epoch``: seed torch for it and draw its
        colour factors (None for a model without vision)."""
        gen = step_generator(self.cfg.SEED, epoch, step)
        if not self.model.vision_backbones:
            return None
        return sample_color_factors(gen, n_clips)

    def _step_augment(self, epoch: int, step: int, n_clips: int) -> dict:
        """The train step's augmentation, as its keyword arguments: the
        colour factors (``_color_factors``), or under a heavy augmentation
        or a process group the step's generator, which the step draws
        them from (``loops.preprocess``; under a group for the global
        batch, and the rank's dropout stream is its own)."""
        tp = self.cfg.train_params
        rank, count = self.procs
        if (count > 1 or tp.use_more_vision_data_augm
                or tp.use_more_audio_data_augm):
            return {"generator": step_generator(self.cfg.SEED, epoch, step,
                                                rank)}
        return {"color_factors": self._color_factors(epoch, step, n_clips)}

    def _export_trace(self, profiler, epoch: int) -> None:
        profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(
            self.cfg.profile_dir, f"train_epoch{epoch}_steps2-4.json"))

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> EpochMetrics:
        cfg = self.cfg
        lr = self.lr_fn(epoch) if self.plateau is None else self.plateau.lr
        O.set_learning_rate(self.state.optimizer, lr)
        set_global_seed(cfg.SEED + epoch)
        rng = np.random.default_rng(cfg.SEED + epoch)
        bsz = cfg.train_params.loader_params.batch_size
        vout, vtar, aout, atar = [], [], [], []
        epoch_loss, n, skip = 0.0, 0, 0
        if self._mid_epoch is not None and self._mid_epoch["epoch"] == epoch:
            me, self._mid_epoch = self._mid_epoch, None
            skip = n = me["step"]
            epoch_loss = me["epoch_loss"]
            vout, aout = list(me["vout"]), list(me["aout"])
            vtar, atar = list(me["vtar"]), list(me["atar"])
        n_proc = self.procs[1]
        loader = PrefetchLoader(
            self.train_ds, bsz // n_proc,
            shuffle=cfg.train_params.loader_params.shuffle,
            rng=rng, wavlm_store=self.wavlm_store,
            prefetch=cfg.train_params.loader_params.prefetch,
            host_shard=self.procs if n_proc > 1 else None)
        profiler = None
        profiling = (bool(cfg.profile_dir) and epoch == cfg.profile_epoch
                     and M.is_main_process())
        copies, step_s = [], []
        t_start = t_log = time.perf_counter()
        seen = 0
        for batch in loader:
            seen += 1
            if seen <= skip:
                continue  # replay the data order; the step ran before
            t_step = time.perf_counter()
            arrays, n_real = self._device_arrays(batch, bsz, copies,
                                                 distributed_load=True)
            s = batch.labels_v.shape[1]
            augment = self._step_augment(epoch, n, bsz * s)
            if profiling and n == 2:
                profiler = torch.profiler.profile()
                profiler.start()
            loss, vouts, aouts = self.train_step(self.state, arrays,
                                                 **augment)
            epoch_loss += float(loss)
            n += 1
            if profiler is not None and n == 5:
                self._export_trace(profiler, epoch)
                profiler = None
            now = time.perf_counter()
            step_s.append(now - t_step)
            if cfg.log_every_steps and n % cfg.log_every_steps == 0:
                self.log.metrics(step=f"e{epoch}s{n}", loss=float(loss),
                                 step_seconds=(now - t_log)
                                 / cfg.log_every_steps, lr=lr)
                t_log = now
            # the epoch's CCC over the real rows of the global batch
            # (row_weight marks them: a rank's pad rows sit at its block's
            # tail)
            keep = np.repeat(M.gather_rows(arrays["row_weight"]) > 0.5, s)
            for acc, x in ((vout, vouts), (aout, aouts),
                           (vtar, arrays["labels_v"]),
                           (atar, arrays["labels_a"])):
                acc.extend(M.gather_rows(x).reshape(-1)[keep])
            if (cfg.preempt_save_steps and cfg.graceful_preemption
                    and n % cfg.preempt_save_steps == 0 and preempt.agreed()):
                self._preempted_mid = {
                    "epoch": epoch, "step": n,
                    "epoch_loss": float(epoch_loss),
                    "vout": np.asarray(vout, np.float32),
                    "aout": np.asarray(aout, np.float32),
                    "vtar": np.asarray(vtar, np.float32),
                    "atar": np.asarray(atar, np.float32)}
                break
        if profiler is not None:  # the epoch ended before step 4
            self._export_trace(profiler, epoch)
        train_s = time.perf_counter() - t_start
        self.last_timing = {
            "train_seconds": train_s, "steps": len(step_s),
            "step_p50_seconds": (float(np.median(step_s)) if step_s
                                 else 0.0),
            "loader_wait_seconds": loader.wait_seconds,
            "loader_wait_share": loader.wait_seconds / max(train_s, 1e-9)}
        if copies:
            copies[-1][1].synchronize()
            self.last_timing["h2d_copy_ms"] = sum(
                a.elapsed_time(b) for a, b in copies)
        if self._preempted_mid is not None:
            return EpochMetrics()
        if self.plateau is not None and n:
            self.plateau.step(epoch_loss / n)
        return EpochMetrics(train_ccc_v=_ccc(vout, vtar),
                            train_ccc_a=_ccc(aout, atar))

    # ------------------------------------------------------------------
    def _stitch(self, dataset, params, with_labels: bool) -> Stitcher:
        bsz = params.loader_params.batch_size
        stitcher = Stitcher(with_labels=with_labels)
        for batch in PrefetchLoader(dataset, bsz, shuffle=False,
                                    wavlm_store=self.wavlm_store,
                                    prefetch=params.loader_params.prefetch):
            arrays, n_real = self._device_arrays(batch, bsz)
            vouts, aouts = self.eval_step(self.state, arrays)
            labels = ((batch.labels_v, batch.labels_a) if with_labels
                      else (None, None))
            stitcher.add_batch(M.gather_rows(vouts), M.gather_rows(aouts),
                               batch.anchors, batch.videos, batch.lengths,
                               *labels, n_real=n_real)
        return stitcher

    def validate(self, dataset=None, store_pkl: str = "") -> EpochMetrics:
        set_global_seed(self.cfg.SEED)
        stitcher = self._stitch(dataset if dataset is not None
                                else self.val_ds, self.cfg.val_params, True)
        ccc_v, ccc_a = stitcher.scores()
        if store_pkl and M.is_main_process():
            stitcher.dump_pkl(store_pkl)
        return EpochMetrics(valid_ccc_v=ccc_v, valid_ccc_a=ccc_a)

    def test(self, dir_out: str, store_pkl: str = "") -> None:
        """Challenge inference: ``{vid}.txt`` per test video."""
        if self.test_ds is None:
            raise ValueError("no test split is configured")
        stitcher = self._stitch(self.test_ds, self.cfg.test_params, False)
        if M.is_main_process():
            write_challenge_txt(stitcher, dir_out)
            if store_pkl:
                stitcher.dump_pkl(store_pkl)

    # ------------------------------------------------------------------
    def snapshot_best(self) -> None:
        """CPU copy of the current weights as the best epoch's."""
        self._best_snapshot = ckpt.host_copy(self.model.state_dict())

    def dump_best(self, acp: Optional[ckpt.AsyncCheckpointer] = None
                  ) -> None:
        """Write the best epoch's components to SavedWeights/ (the current
        weights when no epoch was validated); rank 0 alone."""
        if not M.is_main_process():
            return
        sd = (self._best_snapshot if self._best_snapshot is not None
              else ckpt.host_copy(self.model.state_dict()))
        if acp is not None:
            acp.export_components(self.exp.weights_dir, sd)
        else:
            ckpt.export_components(self.exp.weights_dir, sd)

    def load_components(self, directory: str) -> Dict[str, str]:
        """Load the model from SavedWeights-style component files."""
        if self.state is None:
            self.initialize()
        loaded = ckpt.assemble_from_components(directory, self.model)
        for name, path in loaded.items():
            self.log.log(f"Loaded component weights [{name}]: {path}")
        return loaded

    def _ckpt_extra(self, mid_epoch: Optional[dict] = None) -> dict:
        """The runner's tracking, saved with the train state, so that a
        resumed run picks the best epoch of the whole run."""
        extra = {"best": {k: (int(v) if k == "epoch" else float(v))
                          for k, v in self.best.items()},
                 "tracker": {k: [float(x) for x in v]
                             for k, v in self.tracker.items()}}
        if self._best_snapshot is not None:
            extra["best_snapshot"] = self._best_snapshot
        if self.plateau is not None:
            p = {"lr": float(self.plateau.lr),
                 "num_bad": int(self.plateau.num_bad)}
            if self.plateau.best is not None:
                p["best"] = float(self.plateau.best)
            extra["plateau"] = p
        if mid_epoch is not None:
            extra["mid_epoch"] = mid_epoch
        return extra

    def _restore_extra(self, extra: Optional[dict]) -> None:
        if not extra:
            return
        if extra.get("best"):
            self.best = {k: (int(v) if k == "epoch" else float(v))
                         for k, v in extra["best"].items()}
        if extra.get("tracker"):
            self.tracker = {k: [float(x) for x in v]
                            for k, v in extra["tracker"].items()}
        if extra.get("best_snapshot") is not None:
            self._best_snapshot = extra["best_snapshot"]
        p = extra.get("plateau")
        if p is not None and self.plateau is not None:
            self.plateau.lr = float(p["lr"])
            self.plateau.num_bad = int(p["num_bad"])
            self.plateau.best = float(p["best"]) if "best" in p else None
        me = extra.get("mid_epoch")
        if me is not None:
            self._mid_epoch = {
                "epoch": int(me["epoch"]), "step": int(me["step"]),
                "epoch_loss": float(me["epoch_loss"]),
                **{k: np.asarray(me[k], np.float32)
                   for k in ("vout", "aout", "vtar", "atar")}}

    def _save_state(self, acp: Optional[ckpt.AsyncCheckpointer] = None,
                    mid_epoch: Optional[dict] = None) -> None:
        if not M.is_main_process():
            return
        extra = self._ckpt_extra(mid_epoch)
        if acp is not None:
            acp.save_train_state(self.exp.weights_dir, self.state, extra)
        else:
            ckpt.save_train_state(self.exp.weights_dir, self.state, extra)

    def resume(self) -> bool:
        """Restore the full train state from the experiment dir if it is
        there; returns True if it was."""
        if self.state is None:
            self.initialize()
        path = os.path.join(self.exp.weights_dir, ckpt.STATE_FILE)
        if not os.path.isfile(path):
            return False
        _, extra = ckpt.restore_train_state_with_extra(
            self.exp.weights_dir, self.state)
        self._restore_extra(extra)
        self.cfg.model_params.start_epoch = self.state.epoch
        at = (f" (mid-epoch, step {self._mid_epoch['step']})"
              if self._mid_epoch else "")
        self.log.log(f"resumed from {path} at epoch {self.state.epoch}{at}")
        return True

    def _assert_pod_resume_agreement(self, start: int) -> None:
        """Every rank must start from the same checkpoint: rank 0 alone
        writes ``train_state.pt`` and ``preempted.txt``, so with a
        ``weights_dir`` of its own on each host, a relaunch resumes rank 0
        at epoch E while the others start at 0, and their collectives
        never match. Every rank reaches ``fit``, where this gather fails
        at once instead."""
        _, count = self.procs
        if count == 1:
            return
        mid = self._mid_epoch["step"] if self._mid_epoch else -1
        allv = M.all_agree([start, mid])
        if not (allv == allv[0]).all():
            raise RuntimeError(
                "pod resume disagreement: per-rank (start_epoch, "
                f"mid_epoch_step) = {allv.tolist()}: the ranks restored "
                "different checkpoints. train_state.pt and preempted.txt "
                "are written by rank 0 only; put weights_dir on storage "
                "shared by every rank")

    def fit(self) -> Dict[str, object]:
        if self.exp.already_done():
            self.log.log("experiment already passed; skipping "
                         "(passed.txt guard)")
            return {}
        if M.is_main_process():
            self.exp.create()
        if self.state is None:
            self.initialize()
        cfg = self.cfg
        self._assert_pod_resume_agreement(cfg.model_params.start_epoch)
        if cfg.graceful_preemption:
            preempt.install()
        preempted = False
        acp = (ckpt.AsyncCheckpointer()
               if cfg.async_checkpoint and M.is_main_process() else None)
        try:
            for epoch in range(cfg.model_params.start_epoch,
                               cfg.model_params.max_epochs):
                t0 = time.perf_counter()
                if self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                tm = self.train_epoch(epoch)
                if self._preempted_mid is not None:
                    # the state stays at `epoch`; resume re-enters it and
                    # skips the steps taken
                    me, self._preempted_mid = self._preempted_mid, None
                    self._save_state(acp, mid_epoch=me)
                    self.log.log(f"preemption: state saved mid-epoch "
                                 f"{epoch} at step {me['step']}; re-launch "
                                 f"to resume")
                    preempted = True
                    break
                if cfg.graceful_preemption and preempt.agreed():
                    # keep the finished epoch's training, skip its
                    # validation; resume continues at epoch + 1
                    self.state.epoch = epoch + 1
                    self._save_state(acp)
                    self.log.log(f"preemption: state saved after train "
                                 f"epoch {epoch}; validation skipped; "
                                 f"re-launch to resume at {epoch + 1}")
                    preempted = True
                    break
                t_val = time.perf_counter()
                vm = self.validate()
                validate_s = time.perf_counter() - t_val
                self.tracker["train_v"].append(tm.train_ccc_v)
                self.tracker["train_a"].append(tm.train_ccc_a)
                self.tracker["valid_v"].append(vm.valid_ccc_v)
                self.tracker["valid_a"].append(vm.valid_ccc_a)
                t_ckpt = time.perf_counter()
                if vm.valid_avg >= self.best["avg"]:
                    self.best = {"avg": vm.valid_avg, "epoch": epoch,
                                 "valid_v": vm.valid_ccc_v,
                                 "valid_a": vm.valid_ccc_a}
                    self.snapshot_best()
                    if cfg.dump_best_model_every_time:
                        self.dump_best(acp)
                self.state.epoch = epoch + 1
                self._save_state(acp)
                # the loop's own checkpoint time: the CPU copies, and the
                # wait for the write before (the writes run behind)
                timing = dict(self.last_timing, validate_seconds=validate_s,
                              checkpoint_seconds=time.perf_counter()
                              - t_ckpt)
                if self.device.type == "cuda":
                    timing["peak_allocated_gib"] = \
                        torch.cuda.max_memory_allocated(self.device) / 2 ** 30
                self.log.metrics(step=epoch,
                                 train_ccc_v=tm.train_ccc_v,
                                 train_ccc_a=tm.train_ccc_a,
                                 valid_ccc_v=vm.valid_ccc_v,
                                 valid_ccc_a=vm.valid_ccc_a,
                                 best_epoch=self.best["epoch"],
                                 epoch_seconds=time.perf_counter() - t0,
                                 **timing)
                if cfg.graceful_preemption and preempt.agreed():
                    self.log.log(f"preemption: exiting after full epoch "
                                 f"{epoch}; re-launch to resume")
                    preempted = True
                    break
            if preempted:
                # no passed.txt, so the same command resumes; the marker
                # is written after the state it vouches for
                if acp is not None:
                    acp.wait()
                if M.is_main_process():
                    with open(self.exp.preempted_marker, "w") as f:
                        f.write("graceful preemption; re-launch resumes\n")
                if self._best_snapshot is not None:
                    self.dump_best(acp)
            else:
                self.dump_best(acp)
        finally:
            if acp is not None:
                acp.close()
            if cfg.graceful_preemption:
                preempt.uninstall()
        if not preempted and M.is_main_process():
            self._plot_tracker()
            self.exp.finalize({"best": self.best, "tracker": self.tracker})
        return {"best": self.best, "tracker": self.tracker,
                "preempted": preempted}

    def _plot_tracker(self) -> None:
        """The learning-curve PNG, when matplotlib is installed."""
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for ax, key, title in ((axes[0], "v", "valence CCC"),
                               (axes[1], "a", "arousal CCC")):
            ax.plot(self.tracker[f"train_{key}"], label="train")
            ax.plot(self.tracker[f"valid_{key}"], label="valid")
            if self.best["epoch"] >= 0:
                ax.axvline(self.best["epoch"], ls="--", c="gray")
            ax.set_title(title)
            ax.set_xlabel("epoch")
            ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(self.exp.path, "tracker.png"), dpi=100)
        plt.close(fig)
