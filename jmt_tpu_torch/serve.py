"""Serving: fixed-bucket batched inference, one CUDA graph per bucket.

Counterpart of ``jmt_tpu/serve.py``. A request is padded UP to the
smallest batch bucket, and a request larger than the top bucket is split
into top-bucket chunks, so the forward only ever sees the bucket shapes.
The forward is device preprocessing (one log-mel kernel launch for all
B*S wavs) + backbones (with I3D and ``i3d_fused_inception=True``, one
inception-kernel call per module) + fusion (attention-kernel launches),
under ``torch.inference_mode()``.

* **One CUDA graph per bucket, captured at construction** (the
  counterpart of JAX's ahead-of-time compile per bucket): static input
  buffers per bucket, two warm-up forwards on a side stream (each kernel's
  build, shared-memory attribute and occupancy query, and the device
  constants' first copies happen there, outside the graph), then the
  capture. ``predict`` copies the padded request into the bucket's
  buffers, replays the graph and copies the outputs out. The graph reads
  the parameters where they lie at capture: load weights before building
  the server; ``predict`` raises if the parameters moved since. A capture
  or replay that fails raises; there is no eager fallback. On the CPU the
  server runs the eager forward.
* **Raw audio** (``WavLMFrontend``): a request without wavLM features gets
  them from its audio chunks: a host resample to 16 kHz, per-chunk
  normalization, WavLM on the card (eagerly), the LAST frame of each
  chunk. Context is truncated to the chunk by construction; the offline
  extractor (``data/wavlm_extract.py``) gives full-track features.
* Weights come from a training run (``from_experiment``: the
  ``SavedWeights/`` components of the best epoch, or ``train_state.pt``).
* **int8** (``int8=True``: dynamic activation scales; ``"static"`` with
  ``int8_scales``): eligible backbone convs run the s8 kernels
  (``ops/quant.py``); each graph is captured under the mode, so a static
  graph bakes its scales in. Before each capture one eager forward
  prepares every eligible weight once (quantized and laid out for K5:
  ``quant.collect_int8_weights``), so no graph quantizes a weight; the
  prepared weights are a snapshot, and ``predict`` raises if a parameter
  or buffer changed in place since (its ``_version``). ``calibrate``
  measures static scales on a request and captures the graphs again.
  With I3D chunk streaming (``i3d_chunk``) dynamic int8 runs every chunk
  on the same prepared weights (``quant.stream_chunks``); static int8
  refuses, at construction or ``calibrate``, a bucket that the chunk
  splits, as JAX's server fails there.
* **Tensor parallelism** (``model_mesh``, ``parallel/tp.py``): the
  output channels of the large conv and dense layers split over a list of
  devices (one card may appear more than once), the rest on the lead
  device; a TP server runs eagerly, with no CUDA graph (one graph cannot
  span several devices). In int8 a split conv's weight is prepared once
  per device slice, and calibration's float convs split too.
* **Profiler ranges** (``torch.profiler.record_function``, host events on
  the device trace's clock): ``serve.predict`` around each call, and
  inside it, for each top-bucket chunk in turn, ``serve.stage``
  (conversion, checks, padding and the copies into the bucket's buffers,
  or the frontend's features), ``serve.guard`` (the version and address
  checks), ``serve.replay`` (``serve.forward`` on the eager path) and
  ``serve.readback`` (the wait for the card and the copy out). None runs
  inside a capture.
* ``StreamingSession``: per-video stitched, clipped and smoothed V/A as
  eval windows arrive; ``measure_latency``: request p50/p90 per bucket.

Usage::

    server = InferenceServer.from_experiment(exp_dir)       # on cuda
    v, a = server.predict(clips_u8, audio_f32, wavlm)       # (B,S) each

Command line (seed-0 random weights without ``--exp-dir``; prints the
latency JSON)::

    python -m jmt_tpu_torch.serve [--exp-dir DIR] [--buckets 1,8] \\
        [--heavy] [--wavlm-checkpoint PT] [--int8 | --int8-static] \\
        [--tp N] [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from math import gcd
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from jmt_tpu_torch.device import resolve_device
from jmt_tpu_torch.ops import quant
from jmt_tpu_torch.ops.mel import AUDIO_SAMPLES
from jmt_tpu_torch.parallel import tp
from jmt_tpu_torch.train.loops import calibration_forward, eval_forward

WARMUP_FORWARDS = 2


def _pad(x: np.ndarray, b: int) -> np.ndarray:
    """Zero rows appended up to ``b``."""
    if x.shape[0] == b:
        return x
    return np.concatenate([x, np.zeros((b - x.shape[0],) + x.shape[1:],
                                       x.dtype)])


class WavLMFrontend:
    """WavLM features of a request's raw audio chunks.

    Training-time wavLM features are per-frame embeddings of the full
    audio track (``data/wavlm_extract.py``); a request carries only each
    timestep's ~1 s chunk, whose END is the anchor instant, so the
    frontend runs WavLM over the chunk and keeps its last frame."""

    def __init__(self, model, sample_rate: int = 44100,
                 audio_samples: Optional[int] = None, device=None):
        """model: a ``models.wavlm.WavLMModel``. device: None = the card
        (raises when there is none); ``"cpu"`` runs on the CPU."""
        from jmt_tpu_torch.data.wavlm_extract import WAVLM_SR
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.sr = sample_rate
        self.audio_samples = audio_samples or AUDIO_SAMPLES
        g = gcd(self.sr, WAVLM_SR)
        self._up, self._down = WAVLM_SR // g, self.sr // g

    def resample(self, audio: np.ndarray) -> np.ndarray:
        """(B, S, A) raw chunks at ``sample_rate`` -> (B*S, L16) at 16 kHz,
        each chunk normalized to zero mean and unit variance (host)."""
        from scipy.signal import resample_poly
        b, s, a = audio.shape
        if a != self.audio_samples:
            raise ValueError(f"audio chunks of {a} samples; the frontend "
                             f"takes {self.audio_samples}")
        flat = audio.reshape(b * s, a).astype(np.float32)
        w16 = resample_poly(flat, self._up, self._down, axis=1)
        w16 = w16.astype(np.float32)
        mu = w16.mean(axis=1, keepdims=True)
        sd = w16.std(axis=1, keepdims=True)
        return (w16 - mu) / (sd + 1e-7)

    def embed(self, w16: np.ndarray) -> torch.Tensor:
        """(N, L16) normalized chunks -> (N, hidden) float32 on the
        device: the last WavLM frame of each."""
        with torch.inference_mode():
            x = torch.from_numpy(w16).to(self.device)
            return self.model(x)[:, -1, :].float()

    def features_tensor(self, audio: np.ndarray) -> torch.Tensor:
        """(B, S, A) raw chunks -> (B, S, hidden) float32 on the device."""
        b, s = audio.shape[:2]
        return self.embed(self.resample(audio)).reshape(b, s, -1)

    def features(self, audio: np.ndarray) -> np.ndarray:
        """(B, S, A) raw chunks -> (B, S, hidden) float32."""
        return self.features_tensor(audio).cpu().numpy()

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "WavLMFrontend":
        """From a state-dict file of a Hugging Face ``WavLMModel``
        (``data/wavlm_extract.load_torch_checkpoint``)."""
        from jmt_tpu_torch.data.wavlm_extract import load_torch_checkpoint
        model, _ = load_torch_checkpoint(path)
        return cls(model, **kw)


class BucketGraph:
    """One bucket's CUDA graph: its static input buffers, the captured
    eval forward and its static outputs. ``seconds``: warm-up and
    capture; ``launches``: each kernel's launches inside the capture;
    ``weight_preparations``: int8 weights quantized and laid out inside
    it (0 when the server prepared them); ``aligned_convs`` and
    ``aligned_flop_share``: the captured forward's convs that ran with
    their channels aligned (``ops/conv.py``'s note), and their share of
    its convs' operations by the unpadded shapes."""

    def __init__(self, server: "InferenceServer", b: int):
        from jmt_tpu_torch.ops.conv import aligned_share, conv_counts
        from jmt_tpu_torch.ops.kernels import launch_counts
        from jmt_tpu_torch.ops.kernels.int8_conv import prepare_weight
        t0 = time.perf_counter()
        dev = server.device
        with torch.cuda.device(dev):
            self.inputs = server._example(b)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_FORWARDS):
                    server.forward(self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            prepared = prepare_weight.calls
            convs = conv_counts()
            with torch.cuda.graph(self.graph):
                self.outputs = server.forward(self.inputs)
            after = launch_counts()
            self.aligned_convs, self.aligned_flop_share = aligned_share(
                convs, conv_counts())
            self.weight_preparations = prepare_weight.calls - prepared
            torch.cuda.synchronize(dev)
        self.launches = {k: after[k] - before[k] for k in after}
        self.seconds = time.perf_counter() - t0

    def replay(self) -> Tuple[torch.Tensor, torch.Tensor]:
        self.graph.replay()
        return self.outputs


class InferenceServer:
    """Fixed-bucket batched inference on one model."""

    def __init__(self, model, seq: int = 16, buckets: Sequence[int] = (1, 8),
                 img_size: int = 112, audio_samples: Optional[int] = None,
                 use_wavlm: Optional[bool] = None,
                 wavlm_frontend: Optional[WavLMFrontend] = None,
                 device=None, int8=False, int8_scales=None,
                 model_mesh: Optional[Sequence] = None):
        """device: None = the card (raises when there is none), where each
        bucket's graph is captured here; ``"cpu"`` runs the plain PyTorch
        path eagerly. int8: False, True (dynamic activation scales) or
        ``"static"`` (the calibrated ``int8_scales``, from
        ``train.loops.make_calibration_step`` or ``calibrate``).
        model_mesh: tensor-parallel serving over these devices
        (``parallel/tp.make_model_mesh``), eager, on the lead device
        ``model_mesh[0]`` (``device``, if given, must be it)."""
        if int8 not in (False, True, "static"):
            raise ValueError(f"int8={int8!r}: False, True or 'static'")
        self.int8 = int8
        self.int8_scales = (None if int8_scales is None
                            else [float(v) for v in int8_scales])
        if int8 == "static" and self.int8_scales is None:
            raise ValueError(
                "int8='static' needs int8_scales — pass scales from "
                "train.loops.make_calibration_step, or construct with "
                "int8=True and call .calibrate(clips, audio[, wavlm]) on "
                "a representative request")
        self.model_mesh = (None if model_mesh is None
                           else tp.make_model_mesh(-1, model_mesh))
        if self.model_mesh is None:
            self.device = resolve_device(device)
            self.tp_shardings = None
        else:
            self.device = resolve_device(self.model_mesh[0])
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the model mesh's "
                                 f"lead device {self.device}")
            self.tp_shardings = tp.shard_params(model, self.model_mesh)
        self.model = model.to(self.device).eval()
        self.seq = seq
        self.img = img_size
        self.audio_samples = audio_samples or AUDIO_SAMPLES
        self.use_wavlm = model.use_wavlm if use_wavlm is None else use_wavlm
        self.wavlm_frontend = wavlm_frontend
        self.wavlm_dim = (wavlm_frontend.cfg.hidden_size
                          if wavlm_frontend is not None else 768)
        self.buckets = sorted(set(int(b) for b in buckets))
        self._capture()

    def _capture(self) -> None:
        """In int8, the prepared weights (one eager forward of the smallest
        bucket); then one graph per bucket on the card, under the server's
        int8 mode (the previous graphs released first); none for a TP
        server."""
        self.graphs: Dict[int, BucketGraph] = {}
        self.int8_weights = None
        if self.int8 == "static":
            self._refuse_static_chunks()
        if self.int8:
            example = self._example(self.buckets[0])
            self.int8_weights = quant.collect_int8_weights(
                lambda: self.forward(example))
        self._versions_at = self._versions()
        if self.device.type == "cuda" and self.model_mesh is None:
            for b in self.buckets:
                self.graphs[b] = BucketGraph(self, b)
        self._captured_at = self._addresses()

    def _refuse_static_chunks(self) -> None:
        """Static int8 serves no bucket that I3D chunk streaming splits
        (``ops/quant.stream_chunks``; JAX's server fails there too, with
        'int8 act_scales exhausted')."""
        backbones = getattr(self.model, "backbones", None)
        for b in self.buckets:
            if backbones is not None and \
                    backbones.i3d_chunks(b * self.seq) > 1:
                raise RuntimeError(
                    f"static int8 cannot serve bucket {b}: i3d_chunk="
                    f"{backbones.i3d_chunk} streams its {b * self.seq} clips "
                    f"in chunks, and static scales are one per conv call "
                    f"of a forward that is not streamed (JAX's server "
                    f"fails here too); serve dynamic int8, buckets the "
                    f"chunk does not split, or i3d_chunk=0")

    # ------------------------------------------------------------------
    def _tensors(self):
        return itertools.chain(self.model.parameters(), self.model.buffers())

    def _addresses(self) -> List[int]:
        return [t.data_ptr() for t in self._tensors()]

    def _versions(self) -> List[int]:
        return [t._version for t in self._tensors()]

    def _example(self, b: int) -> Dict[str, torch.Tensor]:
        """Zero inputs of bucket ``b`` on the device."""
        kw = dict(device=self.device)
        arrays = {"clips": torch.zeros(b, self.seq, 8, self.img, self.img, 3,
                                       dtype=torch.uint8, **kw),
                  "audio": torch.zeros(b, self.seq, self.audio_samples, **kw)}
        if self.use_wavlm:
            arrays["wavlm"] = torch.zeros(b, self.seq, self.wavlm_dim, **kw)
        return arrays

    def forward(self, arrays: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eager forward of one bucket-shaped batch of device tensors
        -> (vouts, aouts), in the server's int8 mode, split over its model
        mesh."""
        with tp.tensor_parallel(self.model_mesh):
            return eval_forward(self.model, arrays, self.int8,
                                self.int8_scales if self.int8 == "static"
                                else None, self.int8_weights)

    def calibrate(self, clips: np.ndarray, audio: np.ndarray,
                  wavlm: Optional[np.ndarray] = None) -> List[float]:
        """Measure per-conv activation scales on a representative request
        (one eager calibration forward), switch to static int8 and
        capture the bucket graphs again. Values beyond the calibrated
        range clip: calibrate on data that covers the serving
        distribution. Returns the scales (pass them as ``int8_scales`` to
        skip this). Raises, as JAX's server fails, where I3D chunk
        streaming splits a bucket or the request."""
        self._refuse_static_chunks()
        self.int8_scales = calibration_scales(
            self.model, clips, audio, wavlm, self.wavlm_frontend,
            self.device, self.use_wavlm, self.model_mesh)
        self.int8 = "static"
        self._capture()
        return self.int8_scales

    def _check(self, clips: np.ndarray, audio: np.ndarray,
               wavlm: Optional[np.ndarray]) -> None:
        n = clips.shape[0]
        want = {"clips": (clips, (n, self.seq, 8, self.img, self.img, 3)),
                "audio": (audio, (n, self.seq, self.audio_samples))}
        if self.use_wavlm:
            if wavlm is not None:
                want["wavlm"] = (wavlm, (n, self.seq, self.wavlm_dim))
            elif self.wavlm_frontend is None:
                raise ValueError("the model has a wavLM path: pass wavlm, "
                                 "or attach a WavLMFrontend")
        for name, (x, shape) in want.items():
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: expected shape {shape}, got "
                                 f"{tuple(x.shape)}")

    def _stage(self, b: int, clips: np.ndarray, audio: np.ndarray,
               wavlm: Optional[np.ndarray]) -> Dict[str, torch.Tensor]:
        """A request of at most ``b`` rows, zero-padded to bucket ``b``, on
        the device: in the bucket's static buffers when it has a graph.
        Without ``wavlm`` the frontend computes the features from the
        padded audio."""
        n = clips.shape[0]
        host = {"clips": clips, "audio": audio}
        if self.use_wavlm and wavlm is not None:
            host["wavlm"] = wavlm
        graph = self.graphs.get(b)
        if graph is None:
            arrays = tp.replicate({k: _pad(x, b) for k, x in host.items()},
                                  [self.device])
        else:
            arrays = graph.inputs
            for k, x in host.items():
                arrays[k][:n].copy_(torch.from_numpy(x))
                arrays[k][n:].zero_()
        if self.use_wavlm and wavlm is None:
            feats = self.wavlm_frontend.features_tensor(_pad(audio, b))
            if graph is None:
                arrays["wavlm"] = feats
            else:
                arrays["wavlm"].copy_(feats)
        return arrays

    def _run(self, b: int, arrays: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bucket ``b``'s forward of what ``_stage`` returned, after the
        checks that the weights are still those captured or prepared
        (``serve.guard``): its graph's replay on the card
        (``serve.replay``), the eager forward elsewhere
        (``serve.forward``)."""
        graph = self.graphs.get(b)
        with record_function("serve.guard"):
            if self.int8_weights is not None and \
                    self._versions() != self._versions_at:
                raise RuntimeError(
                    "the model's parameters or buffers changed in place "
                    "after its int8 weights were prepared; the prepared "
                    "weights would be stale: build a new InferenceServer")
            if graph is not None and self._addresses() != self._captured_at:
                raise RuntimeError(
                    "the model's parameters or buffers moved after its CUDA "
                    "graphs were captured (model.to(...)?); the graphs would "
                    "read freed memory: build a new InferenceServer")
        if graph is None:
            with record_function("serve.forward"):
                return self.forward(arrays)
        with record_function("serve.replay"):
            return graph.replay()

    def _stage_rows(self, i: int, clips: np.ndarray, audio: np.ndarray,
                    wavlm: Optional[np.ndarray]
                    ) -> Tuple[int, int, Dict[str, torch.Tensor]]:
        """Rows ``i`` to ``i`` + the top bucket of a checked request,
        staged in the smallest bucket that holds them: (bucket, rows,
        ``_stage``'s arrays)."""
        rows = slice(i, i + self.buckets[-1])
        clips, audio = clips[rows], audio[rows]
        wavlm = None if wavlm is None else wavlm[rows]
        n = clips.shape[0]
        b = next(x for x in self.buckets if x >= n)
        return b, n, self._stage(b, clips, audio, wavlm)

    def _answer(self, b: int, n: int, arrays: Dict[str, torch.Tensor]
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``n`` rows of bucket ``b``'s forward on the host
        (``serve.readback``: the wait for the card and the copy out)."""
        v, a = self._run(b, arrays)
        with record_function("serve.readback"):
            return v[:n].float().cpu().numpy(), a[:n].float().cpu().numpy()

    def predict(self, clips: np.ndarray, audio: np.ndarray,
                wavlm: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """clips (B,S,8,H,W,3) uint8, audio (B,S,A) f32, wavlm (B,S,dim)
        or None with a frontend attached. Pads B up to the smallest
        bucket; splits oversize requests into top-bucket chunks. Returns
        (vouts, aouts) as (B,S) float32. Runs inside the profiler ranges
        that the module docstring lists; the first chunk's ``serve.stage``
        also converts and checks the whole request."""
        with record_function("serve.predict"):
            with record_function("serve.stage"):
                clips = np.asarray(clips, np.uint8)
                audio = np.asarray(audio, np.float32)
                wavlm = None if wavlm is None else np.asarray(wavlm,
                                                              np.float32)
                self._check(clips, audio, wavlm)
                staged = self._stage_rows(0, clips, audio, wavlm)
            parts = [self._answer(*staged)]
            for i in range(self.buckets[-1], clips.shape[0],
                           self.buckets[-1]):
                with record_function("serve.stage"):
                    staged = self._stage_rows(i, clips, audio, wavlm)
                parts.append(self._answer(*staged))
            if len(parts) == 1:
                return parts[0]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))

    # ------------------------------------------------------------------
    @classmethod
    def from_experiment(cls, exp_dir: str, buckets: Sequence[int] = (1, 8),
                        weights: str = "auto",
                        wavlm_frontend: Optional[WavLMFrontend] = None,
                        device=None, int8=False, int8_scales=None,
                        model_mesh: Optional[Sequence] = None
                        ) -> "InferenceServer":
        """Build from a finished training run (``experiment_model``, on
        the model mesh's lead device when there is one); the weights are
        loaded before the graphs are captured."""
        lead = device if model_mesh is None else model_mesh[0]
        return cls(experiment_model(exp_dir, weights, lead),
                   buckets=buckets, wavlm_frontend=wavlm_frontend,
                   device=device, int8=int8, int8_scales=int8_scales,
                   model_mesh=model_mesh)


def experiment_model(exp_dir: str, weights: str = "auto", device=None):
    """The model of a finished training run (``python -m
    jmt_tpu_torch.cli``): ``final_config.yml`` in Eval mode on one device,
    then the weights: ``"components"`` the ``SavedWeights/`` component
    files (the best epoch), ``"state"`` ``train_state.pt`` (the last
    epoch), ``"auto"`` the components when there are any."""
    from jmt_tpu_torch.core.checkpoint import STATE_FILE, restore_train_state
    from jmt_tpu_torch.core.config import Config
    from jmt_tpu_torch.train.runner import Runner
    if weights not in ("auto", "components", "state"):
        raise ValueError(f"weights={weights!r}: 'auto', 'components' or "
                         f"'state'")
    cfg = Config.from_file(os.path.join(exp_dir, "final_config.yml"))
    cfg.Mode = "Eval"
    cfg.mesh_data_parallel = 1
    runner = Runner(cfg, None, None, device=device)
    runner.initialize()
    wdir = os.path.join(exp_dir, "SavedWeights")
    has_components = os.path.isdir(wdir) and any(
        f.endswith(".pt") and f != STATE_FILE for f in os.listdir(wdir))
    if weights == "components" or (weights == "auto" and has_components):
        runner.load_components(wdir)
    else:
        restore_train_state(wdir, runner.state)
    return runner.model


def calibration_scales(model, clips: np.ndarray, audio: np.ndarray,
                       wavlm: Optional[np.ndarray] = None,
                       frontend: Optional[WavLMFrontend] = None,
                       device=None, use_wavlm: Optional[bool] = None,
                       model_mesh: Optional[Sequence] = None
                       ) -> List[float]:
    """Static int8 activation scales of ``model`` from one request at its
    own batch size: ``train.loops.calibration_forward`` (what
    ``make_calibration_step`` runs) on the device (``model_mesh``: its
    float convs split over that mesh, led by ``device``), then
    ``act_scales_from_maxes``. Without ``wavlm`` a model with a wavLM path
    takes the frontend's features."""
    dev = resolve_device(device)
    model.to(dev)
    use_wavlm = model.use_wavlm if use_wavlm is None else use_wavlm
    arrays = {"clips": torch.from_numpy(np.asarray(clips, np.uint8)),
              "audio": torch.from_numpy(np.asarray(audio, np.float32))}
    arrays = {k: x.to(dev) for k, x in arrays.items()}
    if use_wavlm:
        if wavlm is not None:
            arrays["wavlm"] = torch.from_numpy(
                np.asarray(wavlm, np.float32)).to(dev)
        elif frontend is not None:
            arrays["wavlm"] = frontend.features_tensor(np.asarray(audio))
        else:
            raise ValueError("the model has a wavLM path: pass wavlm, or "
                             "a WavLMFrontend")
    with tp.tensor_parallel(model_mesh):
        maxes = calibration_forward(model, arrays)
    return quant.act_scales_from_maxes(maxes)


class StreamingSession:
    """Online per-video inference: eval windows stream in (in dataset
    order, per video), each batch runs through the server at once, and a
    video's stitched, clipped and smoothed V/A trace is there as soon as
    its last window has arrived.

    Usage::

        sess = StreamingSession(server)
        for arrays, anchors, videos, lengths in window_stream:
            sess.feed(arrays["clips"], arrays["audio"], arrays.get("wavlm"),
                      anchors, videos, lengths)
        v_trace, a_trace = sess.finish_video(video_id)
        # or sess.finish_all() -> {vid: (v, a)}
    """

    def __init__(self, server: InferenceServer,
                 v_smooth: int = 20, a_smooth: int = 50):
        from jmt_tpu_torch.eval.stitch import Stitcher
        self.server = server
        self.stitcher = Stitcher(with_labels=False)
        self.v_smooth = v_smooth
        self.a_smooth = a_smooth

    def feed(self, clips: np.ndarray, audio: np.ndarray,
             wavlm: Optional[np.ndarray], anchors: np.ndarray,
             videos: Sequence[str], lengths: Sequence[int]
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Run one batch of eval windows; scatter its predictions into the
        per-video traces. Returns the raw (B,S) outputs."""
        v, a = self.server.predict(clips, audio, wavlm)
        self.stitcher.add_batch(v, a, np.asarray(anchors), list(videos),
                                list(lengths))
        return v, a

    def finish_video(self, vid: str) -> Tuple[np.ndarray, np.ndarray]:
        """Clip to [-1, 1] and smooth (V ``v_smooth``, A ``a_smooth``) one
        completed video. Raises if its last window has not been fed (its
        unseen frames would read as zeros)."""
        from jmt_tpu_torch.ops.smoothing import clip_and_smooth
        st = self.stitcher
        if vid not in st.pred_v:
            raise KeyError(f"unknown video {vid!r}: no windows fed yet")
        if not st.is_complete(vid):
            raise ValueError(
                f"video {vid!r} is incomplete: frames beyond anchor "
                f"{st._max_anchor.get(vid, 0)} of {st.lengths.get(vid)} not "
                f"yet fed — feed the remaining windows before finish_video")
        v, a = clip_and_smooth(torch.from_numpy(st.pred_v[vid]),
                               torch.from_numpy(st.pred_a[vid]),
                               self.v_smooth, self.a_smooth)
        return v.numpy(), a.numpy()

    def finish_all(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        return {vid: self.finish_video(vid) for vid in self.stitcher.pred_v}

    def write_challenge(self, dir_out: str) -> Sequence[str]:
        """The challenge-format txt file of every streamed video."""
        from jmt_tpu_torch.eval.stitch import write_challenge_txt
        return write_challenge_txt(self.stitcher, dir_out)


def measure_latency(server: InferenceServer, bucket: int,
                    iters: int = 16, warmup: int = 2,
                    device_input: bool = False) -> Dict[str, float]:
    """p50/p90 request latency at one bucket, host clock, each request
    ending in a read on the host (the wait for the card).

    The default times ``predict`` end to end: the copies in and out, and
    with a frontend attached the raw-audio path (resample, WavLM).
    ``device_input=True`` stages the request in the bucket's buffers once
    (its wavLM features too) and times the replay (the eager forward on
    the CPU) and a scalar read."""
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 255, (bucket, server.seq, 8, server.img,
                                  server.img, 3), dtype=np.uint8)
    audio = (rng.normal(size=(bucket, server.seq, server.audio_samples))
             * 0.1).astype(np.float32)
    wavlm = (None if server.wavlm_frontend is not None else
             rng.normal(size=(bucket, server.seq, server.wavlm_dim))
             .astype(np.float32)) if server.use_wavlm else None
    if device_input:
        arrays = server._stage(bucket, clips, audio, wavlm)

        def request():
            v, _ = server._run(bucket, arrays)
            float(v.float().sum())
    else:
        def request():
            v, _ = server.predict(clips, audio, wavlm)
            float(v.sum())
    for _ in range(warmup):
        request()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        request()
        times.append(time.perf_counter() - t0)
    times.sort()
    clips_per_req = bucket * server.seq
    p50 = times[len(times) // 2]
    return {"bucket": bucket, "device_input": device_input,
            "p50_ms": p50 * 1e3,
            "p90_ms": times[int(len(times) * 0.9)] * 1e3,
            "p50_ms_per_clip": p50 * 1e3 / clips_per_req,
            "clips_per_s": clips_per_req / p50}


def _selftest_model(heavy: bool):
    """light = R2D1 + ResNet18; heavy = the flagship (R2D1 + I3D,
    ResNet18 + wavLM, encoder_plus_self_attention), bf16."""
    from jmt_tpu_torch.models.jmt_model import JMTModel
    return JMTModel(
        vision_backbones=("R2D1", "I3D") if heavy else ("R2D1",),
        audio_backbones=("ResNet18", "wavLM") if heavy else ("ResNet18",),
        intra_modal_fusion=("encoder_plus_self_attention" if heavy
                            else "None"),
        joint_modalities="TRANSFORMER", output_format="SELF_ATTEN",
        dtype=torch.bfloat16)


def _latencies(server: InferenceServer) -> Dict:
    return {"buckets": {str(b): {
        "relay": measure_latency(server, b),
        "device_resident": measure_latency(server, b, device_input=True)}
        for b in server.buckets}}


def _calibration_request(seq: int, img: int, audio_samples: int,
                         wavlm_dim: Optional[int]):
    """The JAX command line's calibration request: one seed-0 synthetic
    window (clips, audio, and wavLM features unless ``wavlm_dim`` is
    None)."""
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 255, (1, seq, 8, img, img, 3), dtype=np.uint8)
    audio = (rng.normal(size=(1, seq, audio_samples)) * .1).astype(
        np.float32)
    wavlm = (None if wavlm_dim is None else
             rng.normal(size=(1, seq, wavlm_dim)).astype(np.float32))
    return clips, audio, wavlm


def main(argv=None) -> int:
    from jmt_tpu_torch.models.common import init_parameters
    p = argparse.ArgumentParser(description="jmt_tpu_torch server: "
                                "latency per bucket (JSON)")
    p.add_argument("--exp-dir", default=None,
                   help="serve this training run (python -m "
                        "jmt_tpu_torch.cli); default: seed-0 random "
                        "weights")
    p.add_argument("--compilation-cache", default=None,
                   help="accepted and ignored: the server captures its "
                        "CUDA graphs at start and compiles nothing at "
                        "request time")
    p.add_argument("--buckets", default="1,8")
    p.add_argument("--heavy", action="store_true",
                   help="self-test with the full flagship model")
    p.add_argument("--wavlm-checkpoint", default=None,
                   help="WavLM state dict: serve raw audio, computing the "
                        "wavLM features server-side (WavLMFrontend)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel serving over the first N cards "
                        "(parallel/tp.py; eager, no CUDA graphs); with "
                        "--device, N shards on that device")
    p.add_argument("--int8", action="store_true",
                   help="int8 inference, dynamic activation scales "
                        "(ops/quant.py)")
    p.add_argument("--int8-static", action="store_true",
                   help="int8 with static activation scales, calibrated "
                        "on a synthetic request before the graphs are "
                        "captured (production should calibrate on real "
                        "data: InferenceServer.calibrate)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)
    mesh = None
    if args.tp:
        mesh = tp.make_model_mesh(args.tp, None if args.device is None
                                  else [args.device] * args.tp)
    if args.compilation_cache:
        print("note: --compilation-cache is ignored: the server compiles "
              "nothing at request time", file=sys.stderr)
    buckets = tuple(int(x) for x in args.buckets.split(","))
    frontend = None
    if args.exp_dir:
        # the frontend first: the server's wavLM width is the frontend's,
        # and measure_latency then times the raw-audio path
        frontend = (WavLMFrontend.from_checkpoint(args.wavlm_checkpoint,
                                                  device=args.device)
                    if args.wavlm_checkpoint else None)
        model = experiment_model(args.exp_dir, device=args.device
                                 if mesh is None else mesh[0])
    else:
        if args.wavlm_checkpoint:
            print("warning: --wavlm-checkpoint applies only with --exp-dir "
                  "(the synthetic self-test ignores it)", file=sys.stderr)
        model = init_parameters(_selftest_model(args.heavy),
                                torch.Generator().manual_seed(0))
    int8, scales = bool(args.int8), None
    if args.int8_static:
        # calibrate first, so that each bucket's graph is captured once
        wavlm_dim = (None if frontend is not None or not model.use_wavlm
                     else 768)
        req = _calibration_request(16, 112, AUDIO_SAMPLES, wavlm_dim)
        int8, scales = "static", calibration_scales(
            model, *req, frontend=frontend,
            device=args.device if mesh is None else mesh[0],
            model_mesh=mesh)
    server = InferenceServer(model, buckets=buckets, wavlm_frontend=frontend,
                             device=args.device, int8=int8,
                             int8_scales=scales, model_mesh=mesh)
    print(json.dumps(_latencies(server)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
