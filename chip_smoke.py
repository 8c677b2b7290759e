#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jmt_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # one card, no arguments

Phases, each printing one JSON record per line with its seconds; any
failure raises and the script exits non-zero:

1. device and build: the card's name and power limit, nvcc build seconds
   of the four kernel sources, their ptxas lines and registers per kernel;
2. kernels against their plain PyTorch versions on the card (TF32 off):
   log-mel at N=16 and 128 (f32, atol 5e-5; CUDA-events and device-only
   times of K1 and of torch.stft + a mel GEMM, K1's device operations per
   call, asserted to be one, and its registers); attention at the serving
   path's four shapes in f32 (atol 2e-5) and bf16 (atol 1e-2) plus head_dim 64,
   Lq != Lk and L = 128 shapes and the long path's (Lq or Lk > 128: 129,
   300, NoJR's 16 x 129 and 16 x 300, ragged, D 64 and 20), at the four
   served shapes in bf16 and at the long ones also the device-only time
   of K2 and of SDPA (torch.profiler's self device time per call) beside
   the CUDA-events time; the inception module (K3) at all nine
   module specs of the I3D, 16 clips x T 8, f32 (5e-5 of max |plain|) and
   bf16 (1e-2), Mixed_5c's avg_tail launch repeated and held to the first
   bitwise, then timed at 128 clips in bf16 (and each of its
   launches by torch.profiler); K3 with ``pool_in`` at the
   three absorbed modules (Mixed_3b, 4b, 5b on the pre-pool maps of
   MaxPool3d_3a, 4a, 5a), the same tolerances, timed beside the port's
   unfused module and the K3 launch without ``pool_in``, each after
   ``max_pool_same``. Each with the times of kernel, plain version and
   library yardstick (CUDA events), and the bound;
3. the flagship server (the main path): R2D1 MAX + I3D+TCN (112 -> 224 fold)
   with encoder_plus_self_attention, ResNet18 & wavLM with
   encoder_plus_self_attention, JMT SELF_ATTEN, 1 head, 1 layer, at full
   width with seeded random weights, bf16, ``i3d_fused_inception=True``,
   buckets (1, 8), seq 16, 112 px, one CUDA graph per bucket. The server
   built with the launch counters set to 0 before and read after (two
   warm-up forwards and a capture per bucket) and each graph's capture
   (per forward 1 log-mel, 12 attention, 9 inception) asserted; requests
   at batch 1, 3 and 8 through the graphs equal to the eager forward bit
   for bit (bf16), whose launches are counted; then p50/p90 per bucket
   through the graphs beside the eager path's, peak memory, a
   torch.profiler breakdown of one eager forward and of one replay per
   bucket. The earlier phases' servers below are graphed the same way;
4. the same flagship with the flag off (unfused cuDNN inception): launches
   of one bucket-8 request (no inception launch) and its p50, graph and
   eager; the device time of each backbone alone at bucket 8, flag on and
   off;
5. the flagship with its pools absorbed into K3 (path A): the flag-on
   model with the gate ``ops/kernels/inception._ABSORB_POOLS`` on for the
   phase; launches per forward asserted (1 log-mel, 12 attention, 9
   inception, 3 of them with ``pool_in``), p50/p90 at buckets 1 and 8, a
   profile at bucket 8 and the I3D+TCN time;
6. the first slice's configuration (no I3D), an earlier path: launches
   (1 log-mel, 10 attention per forward) and p50 at buckets 1 and 8;
7. K4 (path B, ``jmt_tpu_torch.tools.pool1x1_experiment``): against its
   plain version at the TPU tool's check shapes (f32 within 1e-5, bf16
   within 1e-2 of max |plain|), timed at its six shapes (bf16, 128 clips)
   beside its plain version and max_pool_same + a 1x1 cuDNN conv, with
   its device-only time, its bound and share of it, and its device
   operations per call, asserted to be one; the
   Mixed_4b..4f chain with 4 K4 launches a forward (asserted) and with
   cuDNN alone;
8. card against CPU: the flagship, flag on, one seq-4 request, card f32
   (kernels in a CUDA graph, TF32 off) against CPU f32 (plain versions),
   V/A max abs delta
   <= 1e-3, with the gate off and on; card bf16 against card f32;
9. train: the flagship (flag on, bf16, every backbone frozen) through
   ``train/loops.init_state`` with the config's SGD defaults and
   ``make_train_step``: 3 steps at B = 8, S = 16 with their launches
   asserted (1 log-mel, 12 attention, 9 inception a step), loss and ms
   each (CUDA events), every trainable tensor moved in some step (but
   one the forward never uses, listed) and every backbone parameter and
   BN buffer unchanged (asserted), the p50 of 10 more
   steps, and one step under torch.profiler (forward, backward and
   optimizer device ms, the attention backward's, the idle share, the top
   operations); one step at B = 1, S = 4, card f32 (TF32 off) against CPU
   f32 from the same weights, loss within 1e-4 and updates within 1e-3
   of the step's largest; then ``eval/stitch.validate`` over the ordered
   windows of two synthetic videos (481 and 530 frames) on the trained
   weights, card f32 against CPU f32 at 32 px over the first video,
   stitched CCC within 1e-3, and the trained bf16 model at 112 px over
   both;
10. cli_train: the trainer entry point, ``jmt_tpu_torch.cli.main`` in
   this process, on the flagship (``--config config.json --synthetic
   2:530`` with the reference's flags for R2D1+I3D, ResNet18+wavLM,
   encoder_plus_self_attention, SELF_ATTEN, the inception kernel on),
   batch 8, two epochs into ``build/chip_exps``: 1 K1, 12 K2, 9 K3 a
   train step and a validation forward (asserted), the experiment
   directory's files, each epoch's seconds, step p50, loader-wait share,
   host-to-device copy time, validate seconds and peak memory; the same
   command again is a no-op (``passed.txt``);
11. cli_resume: the same command with ``--preempt_save_steps 3``,
   preempted in epoch 0, exits with ``preempted.txt`` and no
   ``passed.txt``; the same command again resumes and ends where
   cli_train ended (the largest |delta| of the final weights, printed and
   asserted to be 0: bitwise);
12. cli_eval: ``--mode Eval`` on cli_train's directory: the components
   give the best epoch's valid CCC, the state the last epoch's (within
   1e-3); ``--eval-split test`` writes a ``{vid}.txt`` per video;
13. serve: ``InferenceServer.from_experiment`` on cli_train's directory,
   buckets (1, 8): capture seconds and launches per bucket's graph (1 K1,
   12 K2, 9 K3, asserted), requests of 1, 3, 8 and 11 equal to the eager
   forward bit for bit, ``measure_latency`` at buckets 1 and 8 both ways
   beside the eager path, one profiled replay per bucket, peak memory; a
   WavLM base+ (12 layers, seed-0 weights saved under ``build/``) frontend
   through ``from_checkpoint``: a bucket-8 request's 128 chunks as it runs
   (the process's flags, its convs with TF32 off) against CPU f32 within
   1e-4 of max |ref|, beside it the same with cuDNN's TF32 convs (error
   and device ms), its host resample and device ms apart; raw-audio
   requests and their p50 at buckets 1 and 8;
   ``WavLMExtractor.per_frame`` over a 30 s wav (900 frames) against the
   CPU's in f32 (1e-4 of max |ref|); a
   ``StreamingSession`` over two synthetic videos against the stitched,
   smoothed traces of the eager forward (2e-3);
14. cli_default_config: config.json's own model (R2D1 + ResNet18, FC
   head, bf16) for one epoch (1 K1, 6 K2 a forward, asserted); one eval
   forward each of NoJR (4 K2) and FeatureConcatFC (no K2), card f32
   against CPU f32 within 1e-3; NoJR over 129 and 300 rows (K2's long
   path, 4 launches a forward), card f32 against CPU f32 within 1e-3;
15. cli_files_pretrained: the recipe of record from files
   (``phase_cli_files_pretrained``): seeded R2D1 AFFWILD2, ResNet-18
   IMAGENET and I3D AFFWILD2 weights in the reference's layouts, an
   Affwild2-layout tree made by ``data/preprocessing`` under
   ``build/chip_files``, the native library built from
   ``native/jmt_dataio.cc`` (where libjpeg's header is missing, a line
   with the preprocessor's message, the library's WAV half, and the JPEG
   frames decoded by PIL, marked), its WAV decode held to the Python
   one; one flagship epoch of 16 steps through ``cli.main`` with its
   default loaders: launches, the dataset's native decode, the loaded
   backbones equal to the files and frozen, unchanged after the epoch,
   bitwise; loader-wait share and decode rates.

The last lines are the card's ``nvidia-smi`` name and power limit, the
kernels summary JSON, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository beside it, the script exits non-zero
before printing any result.

    python3 chip_smoke.py --mel-ab TREE...   # K1 A/B, e.g. parent . . parent
    python3 chip_smoke.py --k4-ab TREE...    # K4 A/B, the same way
    python3 chip_smoke.py --k3-ab TREE...    # K3's Mixed_5c launch A/B

time K1 at N = 16 and 128, K4 at its six timed shapes (128 clips, bf16)
or K3's Mixed_5c launch (avg_tail, 128 clips, bf16), each with CUDA
events, device-only time and its device operations, for the jmt_tpu_torch
of each TREE in turn, each in a fresh process (``--mel-times`` /
``--k4-times`` / ``--k3-times`` run from that tree), on one card in one
call: a parent tree unpacked with ``git archive`` into the ignored
``build/ab/``.

    python3 chip_smoke.py --determinism

repeats the flagship's eval forward, and each of its K3 and K2 launches,
on the same weights and inputs, prints how far each output moves
(``determinism``), and exits non-zero if any output moved at all.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

F32_PEAK_FLOPS = 67e12      # H100 SXM fp32 (non-tensor) peak
BF16_PEAK_FLOPS = 989e12    # H100 SXM bf16 dense tensor peak
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3

SLICE_CONFIG = dict(vision_backbones=("R2D1",),
                    audio_backbones=("ResNet18", "wavLM"),
                    intra_modal_fusion="encoder_plus_self_attention",
                    num_heads=1, num_layers=1, r2d1_reduce="MAX")
FLAGSHIP_CONFIG = dict(SLICE_CONFIG, vision_backbones=("R2D1", "I3D"),
                       i3d_input_size=224)
# kernel launches per forward of each path (inception_pool_in: the K3
# launches among inception_module_fused's that took pool_in)
_NONE = {"log_mel": 0, "fused_attention": 0, "inception_module_fused": 0,
         "inception_pool_in": 0, "pool3_1x1": 0}
PER_FORWARD = {"flagship": dict(_NONE, log_mel=1, fused_attention=12,
                                inception_module_fused=9),
               "flagship_flag_off": dict(_NONE, log_mel=1,
                                         fused_attention=12),
               "flagship_absorbed": dict(_NONE, log_mel=1,
                                         fused_attention=12,
                                         inception_module_fused=9,
                                         inception_pool_in=3),
               "slice": dict(_NONE, log_mel=1, fused_attention=10),
               "pool1x1_chain": dict(_NONE, pool3_1x1=4)}
# attention problems of one flagship forward at bucket 8 (B=8, S=16, E=512,
# 1 head): the visual and the audio intra-modal fusion, two each
ATTN_PATH_SHAPES = (("intra_modal", 128, 2, 2, 512, 4),
                    ("jmt_encoders", 8, 16, 16, 512, 3),
                    ("jmt_cross_paired", 16, 16, 16, 512, 3),
                    ("self_atten_head", 128, 6, 6, 512, 2))
ATTN_EXTRA_SHAPES = (("head_dim_64", 64, 16, 16, 64),
                     ("lq_ne_lk", 4, 16, 128, 64),
                     ("l128_d512", 4, 128, 128, 512))
# K2's long path (Lq or Lk > 128): NoJR's encoders over 129 and 300 batch
# rows (BH = S = 16 at the trainer's seq), square and ragged problems
ATTN_LONG_SHAPES = (("long_129", 1, 129, 129, 512),
                    ("long_300", 4, 300, 300, 512),
                    ("long_17x300", 2, 17, 300, 512),
                    ("long_300x17", 2, 300, 17, 512),
                    ("nojr_129", 16, 129, 129, 512),
                    ("nojr_300", 16, 300, 300, 512),
                    ("long_d64", 1, 17, 300, 64),
                    ("long_d20", 1, 257, 257, 20))


def emit(record) -> None:
    print(json.dumps(record), flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over iters launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    """Print the phase's seconds when it ends."""
    t0 = time.perf_counter()
    yield
    emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})


def phase_build() -> dict:
    """Build the kernel sources; returns the registers of each compiled
    kernel (its mangled name) by source, from ptxas's report."""
    from jmt_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas, registers = {}, {}
    for name, p in paths.items():
        lines = p.with_suffix(".log").read_text().splitlines()
        ptxas[name] = [ln.strip() for ln in lines
                       if "Used" in ln or "spill" in ln or "arning" in ln]
        fn, registers[name] = None, {}
        for ln in lines:
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
            elif "Used" in ln and "registers" in ln and fn:
                registers[name][fn] = int(ln.split("Used")[1].split()[0])
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas,
          "registers": registers})
    return registers


def launch_ms(fn, reps: int = 3) -> list:
    """Device ms of each kernel of one fn() call, in launch order, from
    torch.profiler over reps calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a process's first profiles may come back with no device event (three
    # in a row seen), or with fewer than reps calls' events: trace again,
    # for up to about 6 s
    for _ in range(30):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA]
        if events and len(events) % reps == 0:
            break
        time.sleep(0.2)
    else:
        raise RuntimeError(f"torch.profiler traced {len(events)} device "
                           f"operations over {reps} calls")
    per_call = len(events) // reps

    def short(name: str) -> str:
        name = name.replace("(anonymous namespace)::", "").replace("void ", "")
        return name.split("(")[0].split("<")[0].split("::")[-1]

    return [[short(events[i].name),
             sum(events[i + j * per_call].device_time_total
                 for j in range(reps)) / reps / 1e3]
            for i in range(per_call)]


def device_ms(fn, reps: int = 20) -> float:
    """Device-only time of one fn() call: the device time of every kernel
    it launches, from torch.profiler, over reps calls."""
    return sum(ms for _, ms in launch_ms(fn, reps))


def mel_audio(gen: torch.Generator, n: int) -> torch.Tensor:
    """n wavs of the served length on the card, the last an all-zero pad
    row of a bucket (it must come out finite)."""
    from jmt_tpu_torch.ops import mel
    audio = (0.1 * torch.randn(n, mel.AUDIO_SAMPLES, generator=gen)).cuda()
    audio[-1] = 0.0
    return audio


def mel_timing(audio: torch.Tensor) -> dict:
    """K1's wrapper on audio: CUDA-events ms per call over 50 back-to-back
    calls, device-only ms, and each device operation of one call (name,
    ms; torch.profiler). Uses only ``log_mel_spec``, so it times any
    tree's K1 (``--mel-ab``)."""
    from jmt_tpu_torch.ops.kernels import melspec
    ops = launch_ms(lambda: melspec.log_mel_spec(audio), reps=20)
    return {"ms": time_ms(lambda: melspec.log_mel_spec(audio)),
            "device_ms": sum(ms for _, ms in ops), "device_ops": ops}


def check_mel(gen: torch.Generator, registers: dict) -> dict:
    """K1 against its plain version at N = 16 (bucket 1 x seq 16) and 128
    (bucket 8), atol 5e-5, then timed beside the plain version and the
    library (``torch.stft`` + a mel GEMM) at both; the record's top-level
    times are N = 128's."""
    from jmt_tpu_torch.ops import mel
    from jmt_tpu_torch.ops.kernels import melspec
    window = torch.hann_window(mel.WIN_LENGTH, periodic=True, device="cuda")
    fb_t = torch.tensor(np.array(mel.mel_filterbank()), device="cuda").T
    by_n = {}
    for n in (16, 128):
        audio = mel_audio(gen, n)
        got = melspec.log_mel_spec(audio)
        want = mel.log_mel_batch(audio)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        if not finite or err > 5e-5:
            raise AssertionError(f"log-mel kernel N={n}: max abs err {err} "
                                 f"(tol 5e-5), finite={finite}")

        def library():
            spec = torch.stft(audio, n_fft=mel.N_FFT,
                              hop_length=mel.HOP_LENGTH,
                              win_length=mel.WIN_LENGTH, window=window,
                              center=True, pad_mode="reflect",
                              return_complex=True)
            db = 10.0 * torch.log10(torch.clamp(
                torch.matmul(fb_t, spec.abs() ** 2), min=mel.AMIN))
            db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
            return (db - mel.SPEC_MEAN) / mel.SPEC_STD

        n_frames = got.shape[-1]
        fft_flops = 5 * mel.N_FFT * np.log2(mel.N_FFT) * ((n_frames + 1) // 2)
        mel_flops = 2 * melspec.filterbank_nnz() * n_frames
        b_ms, b_by = bound(
            n * (mel.AUDIO_SAMPLES + mel.N_MELS * n_frames) * 4,
            n * (fft_flops + mel_flops), F32_PEAK_FLOPS)
        rec = {"shape": [n, mel.AUDIO_SAMPLES], "max_abs_err": err,
               "library_max_abs_err": (library() - want).abs().max().item(),
               **mel_timing(audio),
               "plain_ms": time_ms(lambda: mel.log_mel_batch(audio)),
               "library_ms": time_ms(library),
               "library_device_ms": device_ms(library),
               "bound_ms": b_ms, "bound_by": b_by}
        if len(rec["device_ops"]) != 1:
            raise AssertionError(f"log-mel kernel N={n}: one device "
                                 f"operation a call expected, got "
                                 f"{rec['device_ops']}")
        emit({"phase": "kernel", "kernel": "log_mel", **rec})
        by_n[n] = rec
    return {"name": "log_mel", "route": "cuda",
            "source": "jmt_tpu_torch/csrc/melspec.cu",
            "replaces": "jmt_tpu/ops/pallas/melspec.py:75",
            "dtype": "float32",
            "timing": "N = 128 wavs (bucket 8); ms and library_ms by CUDA "
                      "events over 50 back-to-back calls, device_ms and "
                      "library_device_ms the device time of every kernel "
                      "of one call (torch.profiler); n16: the same at N = 16",
            **{k: v for k, v in by_n[128].items() if k != "shape"},
            "max_abs_err": max(r["max_abs_err"] for r in by_n.values()),
            "registers": registers.get("melspec"),
            "n16": {k: by_n[16][k] for k in (
                "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")}}


def attn_inputs(gen, bh, lq, lk, d, dtype):
    q = 0.2 * torch.randn(bh, lq, d, generator=gen)
    k = torch.randn(bh, lk, d, generator=gen)
    # |out| stays below 1, so one bf16 ulp of rounding stays below 1e-2
    v = 0.25 * torch.randn(bh, lk, d, generator=gen)
    return [x.to(dtype).cuda() for x in (q, k, v)]


def check_attention(gen: torch.Generator) -> dict:
    import torch.nn.functional as F
    from jmt_tpu_torch.ops.kernels import fused_attention as fa
    tol = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
    peak = {torch.float32: F32_PEAK_FLOPS, torch.bfloat16: BF16_PEAK_FLOPS}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    path = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes_ms": 0.0, "ops_ms": 0.0, "device_ms": 0.0,
            "library_device_ms": 0.0}
    shapes = list(ATTN_PATH_SHAPES) + [
        s + (0,) for s in ATTN_EXTRA_SHAPES + ATTN_LONG_SHAPES]
    long_names = {s[0] for s in ATTN_LONG_SHAPES}
    long = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, bh, lq, lk, d, per_fwd in shapes:
            q, k, v = attn_inputs(gen, bh, lq, lk, d, dtype)
            got = fa.fused_attention(q, k, v)
            want = fa.attention_plain(q, k, v)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol[dtype]:
                raise AssertionError(f"attention kernel {name} {dtype}: max "
                                     f"abs err {err} (tol {tol[dtype]})")
            worst[dtype] = max(worst[dtype], err)
            item = q.element_size()
            n_bytes = bh * (2 * lq + 2 * lk) * d * item
            flops = 4 * bh * lq * lk * d
            b_ms, b_by = bound(n_bytes, flops, peak[dtype])

            def library():
                return F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0)

            rec = {"name": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [bh, lq, lk, d], "max_abs_err": err,
                   "ms": time_ms(lambda: fa.fused_attention(q, k, v)),
                   "plain_ms": time_ms(lambda: fa.attention_plain(q, k, v)),
                   "library_ms": time_ms(library),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "launches_per_forward": per_fwd}
            if (per_fwd and dtype == torch.bfloat16) or name in long_names:
                # the served shapes and the long path: device-only time
                # beside the events time (which counts the host's issue
                # rate as well)
                rec["device_ms"] = device_ms(
                    lambda: fa.fused_attention(q, k, v))
                rec["library_device_ms"] = device_ms(library)
            emit({"phase": "kernel", "kernel": "fused_attention", **rec})
            if name in long_names:
                long.append({key: rec[key] for key in (
                    "name", "dtype", "shape", "max_abs_err", "ms",
                    "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "bound_by")})
            if dtype == torch.bfloat16 and per_fwd:
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "device_ms", "library_device_ms"):
                    path[key] += per_fwd * rec[key]
                path["bytes_ms"] += per_fwd * n_bytes / HBM_BYTES_PER_S * 1e3
                path["ops_ms"] += per_fwd * flops / peak[dtype] * 1e3
    return {"name": "fused_attention", "route": "cuda",
            "source": "jmt_tpu_torch/csrc/fused_attention.cu",
            "replaces": "jmt_tpu/ops/pallas/fused_attention.py:66",
            "dtype": "bfloat16",
            "timing": "sum over the 12 launches of one bucket-8 flagship "
                      "forward; ms and library_ms by CUDA events over 50 "
                      "back-to-back calls, device_ms and library_device_ms "
                      "the kernels' self device time (torch.profiler)",
            "max_abs_err": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16],
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "library_ms": path["library_ms"], "bound_ms": path["bound_ms"],
            "device_ms": path["device_ms"],
            "library_device_ms": path["library_device_ms"],
            "bound_by": ("bytes" if path["bytes_ms"] >= path["ops_ms"]
                         else "operations"),
            "long": long}


def inception_modules():
    """(name, C, H = W, spec, pool_in) of the nine modules at 112 px clips
    (the stem fold keeps the 224 px geometry: 28, 14 and 7); pool_in is
    the MaxPool right before the module, or None."""
    from jmt_tpu_torch.models.i3d import I3D_STAGES, module_channels
    cin, out = 192, []
    for i, (name, spec) in enumerate(I3D_STAGES):
        if name.startswith("Mixed"):
            before, pool = I3D_STAGES[i - 1]
            out.append((name, cin, {"3": 28, "4": 14, "5": 7}[name[6]], spec,
                        pool if before.startswith("MaxPool") else None))
            cin = module_channels(spec)
    return out


@torch.no_grad()
def random_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Running statistics and affine parameters off their identity init,
    so that the folding is really exercised."""
    from jmt_tpu_torch.ops.norm import TorchBatchNorm
    for mod in model.modules():
        if isinstance(mod, TorchBatchNorm):
            n = mod.weight.shape[0]
            mod.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
            mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
            mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
            mod.running_var.copy_((1 + 0.1 * torch.randn(n, generator=gen))
                                  .abs())


# repeats of K3's avg_tail launch (Mixed_5c) held to the first bitwise
AVG_TAIL_REPEATS = 10


def check_inception(gen: torch.Generator, absorbed: bool = False) -> dict:
    """K3 against its plain version at every module spec (16 clips, T 8),
    or with ``absorbed`` at the three modules that take a ``pool_in``, x
    then the pre-pool map: f32 within 5e-5 and bf16 within 1e-2 of max
    |plain|; Mixed_5c's avg_tail launch repeated ``AVG_TAIL_REPEATS``
    times, each equal to the first bitwise. Then at 128 clips (bucket 8)
    in bf16 the times of kernel,
    plain version and library (the port's own unfused InceptionModule:
    ``max_pool_same`` first when absorbed, then cuDNN, bf16, channels-last)
    and, when absorbed, of ``max_pool_same`` followed by the K3 launch
    without pool_in. The bound counts the kernel's own input bytes."""
    from jmt_tpu_torch.models.common import init_parameters
    from jmt_tpu_torch.models.i3d import InceptionModule, module_channels
    from jmt_tpu_torch.ops.conv import max_pool_same
    from jmt_tpu_torch.ops.inception import (fold_inception_weights,
                                             inception_plain)
    from jmt_tpu_torch.ops.kernels.inception import inception_module_fused
    tol = {torch.float32: 5e-5, torch.bfloat16: 1e-2}
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") + (
        ("k3_after_pool_ms",) if absorbed else ())
    total = dict.fromkeys(keys + ("bytes_ms", "ops_ms", "flops"), 0.0)
    cuda_gen = torch.Generator(device="cuda").manual_seed(0)
    for name, c, hw, spec, pool in inception_modules():
        if absorbed and pool is None:
            continue
        pool = pool if absorbed else None
        avg = name == "Mixed_5c"
        pre = 2 * hw if absorbed else hw
        kw = dict(pool_in=pool, avg_tail=avg)
        m = InceptionModule(c, spec, dtype=torch.bfloat16, **kw)
        init_parameters(m, gen)
        random_bn(m, gen)
        m = m.cuda().eval()
        rec = {"name": name, "C": c, "HW": hw, "spec": list(spec), **kw}
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(16, 8, pre, pre, c, device="cuda",
                            generator=cuda_gen).relu_().to(dtype)
            x = x.permute(0, 4, 1, 2, 3)                 # channels-last
            fw = fold_inception_weights(m._folded_branch, dtype)
            got = inception_module_fused(x, fw, spec, **kw).float()
            want = inception_plain(x, fw, spec, **kw).float()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            key = "f32" if dtype == torch.float32 else "bf16"
            rec[f"max_abs_err_{key}"], rec[f"rel_err_{key}"] = err, rel
            worst[dtype] = [max(worst[dtype][0], err),
                            max(worst[dtype][1], rel)]
            if not (got.shape == want.shape and torch.isfinite(got).all()
                    and rel <= tol[dtype]):
                raise AssertionError(f"inception kernel {name} {dtype} "
                                     f"pool_in={pool}: relative err {rel} "
                                     f"(tol {tol[dtype]}), shape "
                                     f"{tuple(got.shape)}")
            if avg:  # avg_tail adds its slots in a fixed order
                differ = sum(not torch.equal(inception_module_fused(
                    x, fw, spec, **kw).float(), got)
                    for _ in range(AVG_TAIL_REPEATS))
                rec[f"avg_tail_repeats_differing_{key}"] = differ
                if differ:
                    raise AssertionError(f"inception kernel {name} {dtype}:"
                                         f" {differ} of {AVG_TAIL_REPEATS} "
                                         f"repeats differ from the first")
        x = torch.randn(128, 8, pre, pre, c, device="cuda",
                        generator=cuda_gen).relu_().to(torch.bfloat16)
        x = x.permute(0, 4, 1, 2, 3)
        fw = fold_inception_weights(m._folded_branch, torch.bfloat16)
        o = spec
        flops = 2 * 128 * 8 * hw * hw * (c * (o[0] + o[1] + o[3])
                                         + 27 * o[1] * o[2] + 27 * o[3] * o[4]
                                         + c * o[5])
        co = module_channels(spec)
        out_elems = 128 * (7 * co if avg else 8 * hw * hw * co)
        n_bytes = (x.numel() + out_elems + sum(a.numel() for a in fw)) * 2
        b_ms, b_by = bound(n_bytes, flops, BF16_PEAK_FLOPS)

        def k3_after_pool():
            xp = max_pool_same(x, *pool).contiguous(
                memory_format=torch.channels_last_3d)
            return inception_module_fused(xp, fw, spec)

        with torch.inference_mode():
            rec.update({
                "ms": time_ms(lambda: inception_module_fused(
                    x, fw, spec, **kw), iters=10, warmup=2),
                "plain_ms": time_ms(lambda: inception_plain(
                    x, fw, spec, **kw), iters=5, warmup=1),
                "library_ms": time_ms(lambda: m(x), iters=10, warmup=2)})
            if absorbed:
                rec["k3_after_pool_ms"] = time_ms(k3_after_pool, iters=10,
                                                  warmup=2)
            rec["launch_ms"] = launch_ms(lambda: inception_module_fused(
                x, fw, spec, **kw))
        rec.update({"clips": 128, "gflop": flops / 1e9, "bound_ms": b_ms,
                    "bound_by": b_by,
                    "tflops": flops / rec["ms"] / 1e9})
        emit({"phase": "kernel", "kernel": "inception_module_fused", **rec})
        for key in keys:
            total[key] += rec[key]
        total["bytes_ms"] += n_bytes / HBM_BYTES_PER_S * 1e3
        total["ops_ms"] += flops / BF16_PEAK_FLOPS * 1e3
        total["flops"] += flops
        del m, x, fw
    return {"timing": ("sum over Mixed_3b, 4b and 5b with pool_in"
                       if absorbed else "sum over the 9 modules of one "
                       "bucket-8 forward") + " (128 clips)",
            "max_abs_err": worst[torch.float32][0],
            "rel_err_f32": worst[torch.float32][1],
            "max_abs_err_bf16": worst[torch.bfloat16][0],
            "rel_err_bf16": worst[torch.bfloat16][1],
            **{key: total[key] for key in keys},
            "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                         else "operations"),
            "tflops": total["flops"] / total["ms"] / 1e9}


def make_model(config, dtype, seed: int = 0, **kw):
    from jmt_tpu_torch.models.common import init_parameters
    from jmt_tpu_torch.models.jmt_model import JMTModel
    model = JMTModel(**config, dtype=dtype, **kw)
    return init_parameters(model, torch.Generator().manual_seed(seed))


def request(rng, b: int, seq: int, img: int = 112):
    clips = rng.integers(0, 256, (b, seq, 8, img, img, 3), dtype=np.uint8)
    audio = (0.1 * rng.normal(size=(b, seq, 45599))).astype(np.float32)
    wavlm = rng.normal(size=(b, seq, 768)).astype(np.float32)
    return clips, audio, wavlm


def counted(fn):
    """Run fn with every kernel's launch count set to 0 before; return
    fn's result and the counts read after it."""
    from jmt_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


REQUEST_KEYS = ("clips", "audio", "wavlm")
# every kernel of the forward repeats bitwise (K3's avg_tail adds its
# slots in a fixed order), so a graph replay equals the eager forward
# bit for bit; streamed traces against stitched ones, and raw audio
# against features computed at another batch, are held to 2e-3 (bf16)
STREAM_TOL_BF16 = 2e-3


def eager_predict(server, req) -> tuple:
    """``predict``'s path without the graphs: pad to the bucket (split
    over the top bucket), copy in, the eager ``forward``, copy out."""
    n, top = req[0].shape[0], server.buckets[-1]
    if n > top:
        parts = [eager_predict(server, tuple(None if x is None
                                             else x[i:i + top] for x in req))
                 for i in range(0, n, top)]
        return tuple(np.concatenate([p[j] for p in parts]) for j in (0, 1))
    b = next(x for x in server.buckets if x >= n)
    arrays = {k: torch.from_numpy(np.concatenate(
        [x, np.zeros((b - n,) + x.shape[1:], x.dtype)])).cuda()
        for k, x in zip(REQUEST_KEYS, req) if x is not None}
    v, a = server.forward(arrays)
    return v[:n].float().cpu().numpy(), a[:n].float().cpu().numpy()


def expect_captures(path: str, server) -> None:
    """Each bucket's graph holds one forward's launches of ``path``."""
    for b, graph in server.graphs.items():
        emit({"phase": "capture", "path": path, "bucket": b,
              "seconds": graph.seconds, **graph.launches})
        if graph.launches != PER_FORWARD[path]:
            raise AssertionError(f"{path} bucket {b}: the graph holds "
                                 f"{graph.launches}, expected "
                                 f"{PER_FORWARD[path]}")


def drive(path: str, server, reqs: dict) -> dict:
    """One request per batch size in ``reqs`` through ``predict`` (the
    graphs), each equal to the eager forward bit for bit and finite,
    non-constant V/A; the launches of each graph's capture
    and of the eager forwards (per forward x forwards) asserted. Returns
    the eager forwards' launches."""
    expect_captures(path, server)
    outs = {b: server.predict(*req) for b, req in reqs.items()}
    eager, launches = counted(
        lambda: {b: eager_predict(server, req) for b, req in reqs.items()})
    expected = {k: v * len(reqs) for k, v in PER_FORWARD[path].items()}
    emit({"phase": "launches", "path": path, "eager_forwards": len(reqs),
          **launches})
    if launches != expected:
        raise AssertionError(f"{path}: expected launches {expected} for "
                             f"{len(reqs)} eager forwards, got {launches}")
    for b, (v, a) in outs.items():
        for name, x in (("v", v), ("a", a)):
            if x.shape != (b, server.seq) or not np.isfinite(x).all() \
                    or float(np.std(x)) == 0.0:
                raise AssertionError(f"{path} batch {b} {name}: shape "
                                     f"{x.shape}, finite="
                                     f"{np.isfinite(x).all()}, std={np.std(x)}")
        delta = va_max_abs((v, a), eager[b])
        emit({"phase": "server_output", "path": path, "batch": b,
              "v_std": float(np.std(v)), "a_std": float(np.std(a)),
              "v_mean": float(np.mean(v)), "a_mean": float(np.mean(a)),
              "replay_vs_eager_va_max_abs": delta})
        if delta != 0.0:
            raise AssertionError(f"{path} batch {b}: replay against eager "
                                 f"V/A {delta}, not bitwise")
    return launches


def latencies(path: str, server, req, iters: int = 12) -> None:
    """Request p50/p90 through the graphs beside the eager path's."""
    for mode, fn in (("graph", server.predict),
                     ("eager", lambda *r: eager_predict(server, r))):
        emit({"phase": "server_latency", "path": path, "mode": mode,
              **request_latency(fn, req, iters=iters)})


def phase_flagship(rng) -> tuple:
    """The main path: the flagship server with K3 on, one CUDA graph per
    bucket. Returns the launches of one graphed forward (bucket 8's
    capture), the model and the requests."""
    from jmt_tpu_torch.serve import InferenceServer
    model = make_model(FLAGSHIP_CONFIG, torch.bfloat16,
                       i3d_fused_inception=True)
    # two warm-up forwards and the capture per bucket
    server, built = counted(lambda: InferenceServer(model, seq=16,
                                                    buckets=(1, 8)))
    expect_launches("flagship server build", built, PER_FORWARD["flagship"],
                    3 * len(server.buckets))
    reqs = {b: request(rng, b, 16) for b in (1, 3, 8)}
    drive("flagship", server, reqs)

    # bf16 serving under PyTorch's default flags (cuDNN may use TF32 for
    # the f32-engine convs whose channel counts are not multiples of 8)
    torch.cuda.reset_peak_memory_stats()
    flags = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit({"phase": "server_flags", "path": "flagship", **flags})
    for b in (1, 8):
        latencies("flagship", server, reqs[b])
    emit({"phase": "server_memory", "path": "flagship",
          "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    for b in (1, 8):
        profile_forward("flagship", server, reqs[b])
        profile_replay("flagship", server, b)
    return server.graphs[8].launches, model, reqs


def phase_flag_off(model_on, req8) -> None:
    """The flagship with the unfused cuDNN inception (the flag's "auto"
    value), the same weights; then each backbone alone at bucket 8."""
    from jmt_tpu_torch.serve import InferenceServer
    model = make_model(FLAGSHIP_CONFIG, torch.bfloat16,
                       i3d_fused_inception=False)
    model.load_state_dict(model_on.state_dict())
    server = InferenceServer(model, seq=16, buckets=(1, 8))
    drive("flagship_flag_off", server, {8: req8})
    latencies("flagship_flag_off", server, req8)
    profile_forward("flagship_flag_off", server, req8)
    del server
    layer_times(model_on, model, req8)


@contextlib.contextmanager
def absorb_pools():
    """The gate of K3's pool prologue on, restored after."""
    from jmt_tpu_torch.ops.kernels import inception
    saved = inception._ABSORB_POOLS
    inception._ABSORB_POOLS = True
    try:
        yield
    finally:
        inception._ABSORB_POOLS = saved


def phase_absorbed(model_on, reqs) -> dict:
    """Path A: the flag-on model with the pools absorbed into K3 (the gate
    is read at forward time, so its graphs are captured under it); returns
    the launches of one graphed forward."""
    from jmt_tpu_torch.serve import InferenceServer
    server = InferenceServer(model_on, seq=16, buckets=(8,))
    flag_on = [server.predict(*reqs[8]) for _ in range(2)]
    del server
    with absorb_pools():
        server = InferenceServer(model_on, seq=16, buckets=(1, 8))
        drive("flagship_absorbed", server, reqs)
        absorbed = server.predict(*reqs[8])
        # flag on twice: the run-to-run spread (avg_tail sums by atomics)
        emit({"phase": "absorbed_vs_flag_on", "batch": 8,
              "va_max_abs": va_max_abs(absorbed, flag_on[0]),
              "flag_on_rerun_va_max_abs": va_max_abs(*flag_on)})
        for b in (1, 8):
            latencies("flagship_absorbed", server, reqs[b])
        profile_forward("flagship_absorbed", server, reqs[8])
        x = i3d_input(model_on, reqs[8])
        with torch.inference_mode():
            emit({"phase": "layers", "batch": int(reqs[8][0].shape[0]),
                  "i3d_tcn_absorbed_ms": time_ms(
                      lambda: model_on.backbones._i3d_trunk(x), iters=5,
                      warmup=1)})
    return server.graphs[8].launches


def va_max_abs(x, y) -> float:
    """Max abs delta of two (V, A) results over both."""
    return max(float(np.abs(x[i] - y[i]).max()) for i in range(2))


def i3d_input(model, req) -> torch.Tensor:
    """The I3D trunk's input (B S, 3, T, H, W) of one request, on the card."""
    from jmt_tpu_torch.train.loops import preprocess
    arrays = {k: torch.from_numpy(x).cuda()
              for k, x in zip(("clips", "audio", "wavlm"), req)}
    with torch.inference_mode():
        _, clips = preprocess(model, arrays)
    return clips.reshape(-1, *clips.shape[2:]).permute(0, 4, 1, 2, 3)


def layer_times(model_on, model_off, req) -> None:
    """Device ms (CUDA events) of each backbone alone on one bucket-8
    batch already on the card: R2D1, audio ResNet-18, the I3D+TCN with the
    flag on and off, and the folded I3D stem (conv + 15 corrections + BN)."""
    from jmt_tpu_torch.train.loops import preprocess
    arrays = {k: torch.from_numpy(x).cuda()
              for k, x in zip(("clips", "audio", "wavlm"), req)}
    with torch.inference_mode():
        spec, clips = preprocess(model_on, arrays)
        b, s = clips.shape[:2]
        flat = clips.reshape(b * s, *clips.shape[2:])
        x_i3d = flat.permute(0, 4, 1, 2, 3)
        x_r2d1 = x_i3d.contiguous()
        x_spec = spec.reshape(b * s, 1, *spec.shape[2:])
        bb_on, bb_off = model_on.backbones, model_off.backbones
        rec = {
            "i3d_tcn_flag_on_ms": time_ms(lambda: bb_on._i3d_trunk(x_i3d),
                                          iters=5, warmup=1),
            "i3d_tcn_flag_off_ms": time_ms(lambda: bb_off._i3d_trunk(x_i3d),
                                           iters=5, warmup=1),
            "i3d_stem_fold_ms": time_ms(
                lambda: bb_on.vision_i3d.i3d_WSDDA.Conv3d_1a_7x7.upsampled2x(
                    x_i3d), iters=5, warmup=1),
            "r2d1_ms": time_ms(lambda: bb_on.vision_r2d1(x_r2d1), iters=5,
                               warmup=1),
            "audio_resnet18_ms": time_ms(lambda: bb_on.audio_resnet18(x_spec),
                                         iters=5, warmup=1)}
    emit({"phase": "layers", "batch": int(b), **rec})


def phase_slice(rng) -> None:
    """The first slice's configuration (no I3D), kept as an earlier path."""
    from jmt_tpu_torch.serve import InferenceServer
    server = InferenceServer(make_model(SLICE_CONFIG, torch.bfloat16),
                             seq=16, buckets=(1, 8))
    reqs = {b: request(rng, b, 16) for b in (1, 8)}
    drive("slice", server, reqs)
    for b in (1, 8):
        latencies("slice", server, reqs[b], iters=8)


def phase_pool1x1(registers: dict) -> dict:
    """Path B: K4 through its experiment entry point
    (``jmt_tpu_torch.tools.pool1x1_experiment``); returns K4's record. At
    each of the six timed shapes also K4's device-only time and its device
    operations per call, asserted to be one: from ``--k4-times`` in a fresh
    process, because late in this one torch.profiler dropped some of K4's
    device operations from every trace."""
    from jmt_tpu_torch.tools import pool1x1_experiment as pe
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = pe.check(gen)
    timed = [pe.time_case(shape, co, gen)
             for mode in ("time", "time2")
             for shape, co in pe.TIME_SHAPES[mode]]
    fresh = {(tuple(r["shape"]), r["co"]): r
             for r in tree_times(os.path.dirname(os.path.abspath(__file__)),
                                 "k4")}
    for rec in timed:
        ab = fresh[(tuple(rec["shape"]), rec["co"])]
        rec.update(device_ms=ab["device_ms"], device_ops=ab["device_ops"],
                   bound_share=rec["bound_ms"] / ab["device_ms"])
        if len(rec["device_ops"]) != 1:
            raise AssertionError(f"pool3_1x1 kernel {rec['shape']}: one "
                                 f"device operation a call expected, got "
                                 f"{rec['device_ops']}")
    for rec in checks + timed:
        emit({"phase": "kernel", "kernel": "pool3_1x1", **rec})
    x = torch.randn(*pe.CHAIN_INPUT, device="cuda", generator=gen)
    x = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        y_k4, launches = counted(lambda: pe.build_chain(True).cuda()(x))
        y_cudnn = pe.build_chain(False).cuda()(x)
    emit({"phase": "launches", "path": "pool1x1_chain", "forwards": 1,
          **launches})
    if launches != PER_FORWARD["pool1x1_chain"]:
        raise AssertionError(f"pool1x1 chain: expected launches "
                             f"{PER_FORWARD['pool1x1_chain']}, got "
                             f"{launches}")
    chain_rel = ((y_k4.float() - y_cudnn.float()).abs().max()
                 / y_cudnn.float().abs().max()).item()
    chains = {rec["k4_b3"]: rec for rec in (pe.chain(True, gen, x),
                                            pe.chain(False, gen, x))}
    emit({"phase": "pool1x1_chain", "k4_ms": chains[True]["chain_ms"],
          "cudnn_ms": chains[False]["chain_ms"],
          "out_rel_delta_k4_vs_cudnn": chain_rel})
    if not (torch.isfinite(y_k4).all() and chain_rel <= 0.1):
        raise AssertionError(f"pool1x1 chain: K4 against cuDNN relative "
                             f"delta {chain_rel} (limit 0.1)")
    main = next(r for r in timed
                if r["shape"] == [128, 8, 14, 14, 512] and r["co"] == 64)
    f32 = [r for r in checks if r["dtype"] == "float32"]
    bf16 = [r for r in checks + timed if r["dtype"] == "bfloat16"]
    keys = ("ms", "device_ms", "bound_ms", "bound_by", "bound_share",
            "plain_ms", "library_ms")
    return {"name": "pool3_1x1", "route": "cuda",
            "source": "jmt_tpu_torch/csrc/pool1x1.cu",
            "replaces": "tools/pallas_pool1x1_experiment.py:76",
            "dtype": "bfloat16",
            "timing": "(128, 8, 14, 14, 512) -> 64 bf16; ms, plain_ms and "
                      "library_ms by CUDA events, device_ms the kernel's "
                      "device time (torch.profiler, --k4-times in a fresh "
                      "process), bound_share bound_ms / device_ms; shapes: "
                      "the six timed shapes; launches: one forward of the "
                      "Mixed_4b..4f chain",
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "rel_err_f32": max(r["rel_err"] for r in f32),
            "max_abs_err_bf16": max(r["max_abs_err"] for r in bf16),
            "rel_err_bf16": max(r["rel_err"] for r in bf16),
            **{k: main[k] for k in keys},
            "shapes": [{"shape": r["shape"], "co": r["co"],
                        **{k: r[k] for k in keys}} for r in timed],
            "registers": registers.get("pool1x1"),
            "chain_ms": chains[True]["chain_ms"],
            "chain_cudnn_ms": chains[False]["chain_ms"],
            "launches": launches["pool3_1x1"]}


def request_latency(predict, req, iters: int = 12, warmup: int = 2) -> dict:
    """p50/p90 of ``predict(*req)`` on the host clock (it returns numpy, so
    each call ends synchronized), and clips/s at the p50."""
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        predict(*req)
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    b, seq = req[0].shape[:2]
    p50 = times[len(times) // 2]
    return {"bucket": int(b), "p50_ms": p50,
            "p90_ms": times[int(len(times) * 0.9)],
            "clips_per_s": b * seq / (p50 / 1e3)}


def profile_forward(path: str, server, req, reps: int = 3) -> None:
    """Device kernel time by name over ``reps`` forwards of one bucket-shaped
    batch already on the card, against their wall time: the device's busy
    and idle share of the forward (host-to-device copies excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    arrays = {k: torch.from_numpy(x).cuda()
              for k, x in zip(("clips", "audio", "wavlm"), req)}
    server.forward(arrays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            server.forward(arrays)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(ev.self_device_time_total / reps / 1e3, ev.key[:90],
             ev.count // reps)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    emit({"phase": "profile", "path": path, "batch": int(req[0].shape[0]),
          "wall_ms_per_forward": wall_ms, "device_ms_per_forward": busy,
          "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
          "kernels_per_forward": sum(r[2] for r in rows),
          "top": [{"ms": r[0], "name": r[1], "calls": r[2]}
                  for r in rows[:25]]})


def profile_replay(path: str, server, b: int, reps: int = 3) -> None:
    """One bucket's graph replayed ``reps`` times under torch.profiler:
    device ms, idle share and kernels per replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    graph = server.graphs[b]
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(ev.self_device_time_total / reps / 1e3, ev.count / reps)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    emit({"phase": "profile_replay", "path": path, "batch": b,
          "wall_ms_per_replay": wall_ms, "device_ms_per_replay": busy,
          "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
          "kernels_per_replay": sum(r[1] for r in rows)})


def phase_card_vs_cpu() -> None:
    """The flagship, flag on, with the pools pooled first and absorbed:
    card f32 (kernels, TF32 off) against CPU f32 (plain versions)."""
    from jmt_tpu_torch.serve import InferenceServer
    rng = np.random.default_rng(1)
    req = request(rng, 1, 4)
    cfg = dict(FLAGSHIP_CONFIG, i3d_fused_inception=True)
    bf16 = make_model(cfg, torch.bfloat16)
    sd = bf16.state_dict()
    f32_card, f32_cpu = make_model(cfg, None), make_model(cfg, None)
    f32_card.load_state_dict(sd)
    f32_cpu.load_state_dict(sd)
    runs = (("card_bf16", bf16, None, False),
            ("card_f32", f32_card, None, False),
            ("cpu_f32", f32_cpu, "cpu", False),
            ("card_f32_absorbed", f32_card, None, True),
            ("cpu_f32_absorbed", f32_cpu, "cpu", True))
    out = {}
    for name, model, dev, absorbed in runs:
        with absorb_pools() if absorbed else contextlib.nullcontext():
            server = InferenceServer(model, seq=4, buckets=(1,), device=dev)
            out[name], launches = counted(lambda: server.predict(*req))
        if server.graphs:  # the card's: the launches its graph holds
            launches = server.graphs[1].launches
        del server
        emit({"phase": "card_vs_cpu_launches", "run": name, **launches})
        if name == "card_f32_absorbed" and launches["inception_pool_in"] != 3:
            raise AssertionError(f"{name}: 3 pool_in launches expected, got "
                                 f"{launches}")
    d_cpu = va_max_abs(out["card_f32"], out["cpu_f32"])
    d_abs = va_max_abs(out["card_f32_absorbed"], out["cpu_f32_absorbed"])
    emit({"phase": "card_vs_cpu", "card_f32_vs_cpu_f32_max_abs": d_cpu,
          "absorbed_card_f32_vs_cpu_f32_max_abs": d_abs,
          "card_bf16_vs_card_f32_max_abs": va_max_abs(out["card_bf16"],
                                                      out["card_f32"]),
          "va_std_cpu": float(np.std(out["cpu_f32"][0]))})
    if not (d_cpu <= 1e-3 and d_abs <= 1e-3):
        raise AssertionError(f"card f32 vs CPU f32 V/A delta {d_cpu}, "
                             f"absorbed {d_abs} (limit 1e-3)")


# ---------------------------------------------------------------------------
# train: the flagship's frozen-backbone train step, eval step and stitcher
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S = 8, 16
TRAIN_TIMED_STEPS = 10
# the stitched eval: two synthetic videos in ordered windows of S frames
STITCH_VIDEOS = (("video_a", 481), ("video_b", 530))


def train_config(model_config, **opt):
    """The config of a model: its backbones, every one frozen (the
    defaults), SGD with Nesterov momentum and ``mystep`` (the defaults,
    lr 1e-4, unless ``opt`` says otherwise)."""
    from jmt_tpu_torch.core.config import Config, ModelParams, OptimParams
    return Config(model_params=ModelParams(
        l_vision_backbones=list(model_config["vision_backbones"]),
        l_audio_backbones=list(model_config["audio_backbones"]),
        intra_modal_fusion=model_config["intra_modal_fusion"],
        opt=OptimParams(**opt)))


def train_arrays(rng, b: int, seq: int, img: int = 112) -> dict:
    """A request's inputs, labels uniform in [-1, 1] with -5 in the last
    seq // 5 slots of row 0, ``row_weight`` with its last row zero (when
    b > 1)."""
    clips, audio, wavlm = request(rng, b, seq, img)
    labels = rng.uniform(-1, 1, (2, b, seq)).astype(np.float32)
    labels[:, 0, -max(1, seq // 5):] = -5.0
    row_weight = np.ones(b, np.float32)
    if b > 1:
        row_weight[-1] = 0.0
    return {"clips": clips, "audio": audio, "wavlm": wavlm,
            "labels_v": labels[0], "labels_a": labels[1],
            "row_weight": row_weight}


def events_ms(fn):
    """fn()'s result and its time on the card's stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def moved_and_changed(model, before: dict, trainable) -> tuple:
    """(trainable tensors that moved, backbone tensors, parameters and BN
    buffers, that changed) against the ``before`` state dict."""
    after = model.state_dict()
    moved = {n for n in trainable if not torch.equal(after[n], before[n])}
    changed = [k for k, v in after.items() if k.startswith("backbones.")
               and not torch.equal(v, before[k])]
    return moved, changed


TRAIN_RANGES = ("train_step.forward", "train_step.backward",
                "train_step.optimizer", "attention_core_bwd")


def profile_train_step(step, state, arrays, gen) -> dict:
    """One train step under torch.profiler: device time by phase, busy
    and idle share against the host clock, the top operations. The
    forward's is the device time of the kernels that start inside the
    ``train_step.forward`` range's span on the device (the kernels
    launched through ctypes, K1, K2 and K3, have no op to be attributed
    to); the optimizer's, that of the kernels its range launched; the
    backward's, the rest (they run on autograd's thread); the attention
    backward's, that of the kernels the ``attention_core_bwd`` ranges
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):   # a process's first traces can come back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, arrays, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((ev.self_device_time_total / 1e3, ev.key[:90],
                        ev.count) for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CUDA
                       and ev.key not in TRAIN_RANGES
                       and ev.self_device_time_total > 0), reverse=True)
        if rows:
            break
    else:
        raise RuntimeError("torch.profiler traced no device operation of "
                           "the train step")
    events = prof.events()
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and ev.name not in TRAIN_RANGES]
    launched = dict.fromkeys(TRAIN_RANGES, 0.0)  # kernels a CPU range launched
    fwd_span = None
    for ev in events:
        if ev.name in TRAIN_RANGES and ev.device_type == DeviceType.CPU:
            launched[ev.name] += ev.device_time_total / 1e3
        elif ev.name == "train_step.forward":
            fwd_span = ev.time_range
    if fwd_span is None:
        raise RuntimeError("the trace has no device span of "
                           "train_step.forward")
    busy = sum(ev.device_time_total for ev in kernels) / 1e3
    fwd = sum(ev.device_time_total for ev in kernels
              if fwd_span.start <= ev.time_range.start < fwd_span.end) / 1e3
    opt = launched["train_step.optimizer"]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "forward_device_ms": fwd, "optimizer_device_ms": opt,
            "backward_device_ms": busy - fwd - opt,
            "attention_bwd_device_ms": launched["attention_core_bwd"],
            "forward_device_span_ms": (fwd_span.end - fwd_span.start) / 1e3,
            "kernels": len(kernels),
            "top": [{"ms": r[0], "name": r[1], "calls": r[2]}
                    for r in rows[:20]]}


def phase_train(rng):
    """The flagship's train step on the card: init_state, 3 counted steps
    (launches, loss, ms each), what moved and what stayed, the p50 of 10
    more, one profiled step. Returns the trained state."""
    from jmt_tpu_torch.models.jmt_model import JMTModel
    from jmt_tpu_torch.train import loops
    model = JMTModel(**FLAGSHIP_CONFIG, dtype=torch.bfloat16,
                     i3d_fused_inception=True)
    state = loops.init_state(model, train_config(FLAGSHIP_CONFIG),
                             torch.Generator().manual_seed(0))
    step = loops.make_train_step(model)
    arrays = {k: torch.from_numpy(x).cuda()
              for k, x in train_arrays(rng, TRAIN_B, TRAIN_S).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    moved, changed = set(), []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        before = snapshot(model)
        ((loss, v, a), ms), launches = counted(
            lambda: events_ms(lambda: step(state, arrays, gen)))
        moved_now, changed_now = moved_and_changed(model, before,
                                                   state.trainable)
        moved |= moved_now
        changed += changed_now
        emit({"phase": "train_step", "step": i, "batch": TRAIN_B,
              "seq": TRAIN_S, "loss": float(loss), "ms": ms, **launches})
        if launches != PER_FORWARD["flagship"]:
            raise AssertionError(f"train step {i}: expected launches "
                                 f"{PER_FORWARD['flagship']}, got "
                                 f"{launches}")
        if not (torch.isfinite(loss) and v.shape == a.shape ==
                (TRAIN_B, TRAIN_S) and torch.isfinite(v).all()
                and torch.isfinite(a).all()):
            raise AssertionError(f"train step {i}: loss {float(loss)}, "
                                 f"outputs {tuple(v.shape)}")
    # a tensor moves in some step (the V/A heads' last bias moves a few
    # ulps a step at the defaults' lr 1e-4, back and forth: CCC's
    # gradient is nearly shift-free); torch's optimizers skip a tensor the
    # forward never uses (the visual fusion's 768 -> 512 fc: both vision
    # streams are 512-d)
    unused = [n for n, p in model.named_parameters()
              if p.requires_grad and p.grad is None]
    still = [n for n in state.trainable if n not in moved]
    emit({"phase": "train_state", "trainable": len(state.trainable),
          "frozen": len(state.frozen), "not_moved": still,
          "no_gradient": unused, "frozen_changed": changed,
          "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if still != unused or changed or not state.frozen:
        raise AssertionError(f"train: trainable tensors that did not move "
                             f"in any step {still} (no gradient {unused}), "
                             f"frozen ones that changed {changed[:5]}")
    times = sorted(events_ms(lambda: step(state, arrays, gen))[1]
                   for _ in range(TRAIN_TIMED_STEPS))
    emit({"phase": "train_latency", "batch": TRAIN_B, "seq": TRAIN_S,
          "steps": TRAIN_TIMED_STEPS, "p50_ms": times[len(times) // 2],
          "min_ms": times[0], "max_ms": times[-1],
          "clips_per_s": TRAIN_B * TRAIN_S / times[len(times) // 2] * 1e3})
    emit({"phase": "train_profile", "batch": TRAIN_B,
          **profile_train_step(step, state, arrays, gen)})
    return state


def update_gap(model, before: dict, want_after: dict, want_before: dict,
               trainable) -> dict:
    """The largest gap between two runs' updates (new - old) of the
    trainable tensors, less an ulp of the new value: against the step's
    largest |update| and against each tensor's own."""
    after = model.state_dict()
    gaps, scales = {}, {}
    for n in trainable:
        got = (after[n] - before[n]).cpu().double()
        want_new = want_after[n].cpu().double()
        want = want_new - want_before[n].cpu().double()
        slack = torch.from_numpy(np.spacing(np.abs(
            want_after[n].cpu().numpy()))).double()
        gaps[n] = float(((got - want).abs() - slack).clamp(min=0).max())
        scales[n] = float(want.abs().max())
    step_scale = max(scales.values())
    worst = max(gaps, key=lambda n: gaps[n] / max(scales[n], 1e-30))
    return {"of_step_scale": max(gaps.values()) / step_scale,
            "step_scale": step_scale, "worst_tensor": worst,
            "worst_of_own_scale": gaps[worst] / max(scales[worst], 1e-30)}


def phase_train_card_vs_cpu() -> None:
    """One flagship train step at B = 1, S = 4 from the same weights and
    colour factors, SGD at lr 1e-2 (the CPU tests'): card f32 (kernels,
    TF32 off) against CPU f32 (plain versions); loss within 1e-4, updates
    within 1e-3 of the step's largest |update| (the CPU tests' bound for
    the slice, whose fusion the flagship shares,
    ``tests/test_torch_train.py``); the worst tensor against its own
    largest update is printed."""
    from jmt_tpu_torch.data.transforms import sample_color_factors
    from jmt_tpu_torch.train import loops
    rng = np.random.default_rng(2)
    arrays = train_arrays(rng, 1, 4)
    factors = sample_color_factors(torch.Generator().manual_seed(1), 4)
    cfg = dict(FLAGSHIP_CONFIG, i3d_fused_inception=True)
    sd = make_model(cfg, torch.bfloat16).state_dict()
    runs = {}
    for name, dev in (("card_f32", None), ("cpu_f32", "cpu")):
        model = make_model(cfg, None)
        model.load_state_dict(sd)
        state = loops.init_state(model, train_config(cfg, lr=1e-2),
                                 device=dev)
        step = loops.make_train_step(model, device=dev)
        before = snapshot(model)
        (loss, _, _), launches = counted(
            lambda: step(state, arrays, color_factors=factors))
        emit({"phase": "train_card_vs_cpu_launches", "run": name,
              **launches})
        runs[name] = (model, state, before, float(loss))
    (card, state, before, loss_card), (cpu, _, cpu_before, loss_cpu) = \
        runs["card_f32"], runs["cpu_f32"]
    gap = update_gap(card, before, cpu.state_dict(), cpu_before,
                     state.trainable)
    emit({"phase": "train_card_vs_cpu", "loss_card": loss_card,
          "loss_cpu": loss_cpu, "loss_delta": abs(loss_card - loss_cpu),
          **gap})
    if not (abs(loss_card - loss_cpu) <= 1e-4
            and gap["of_step_scale"] <= 1e-3):
        raise AssertionError(f"train step card f32 vs CPU f32: loss "
                             f"{loss_card} vs {loss_cpu}, updates {gap}")


def stitch_batches(seed: int, img: int, b: int = TRAIN_B,
                   seq: int = TRAIN_S, videos=STITCH_VIDEOS):
    """The ordered windows of the synthetic videos, b windows a batch
    (the last padded, ``n_real`` set), each made from ``seed`` when it is
    asked for: labels follow slow sines with noise and a few -5 slots."""
    from types import SimpleNamespace
    rows = [(vid, length, w) for vid, length in videos
            for w in range(-(-length // seq))]
    for i in range(0, len(rows), b):
        part = rows[i:i + b]
        n_real = len(part)
        part = part + [part[0]] * (b - n_real)
        rng = np.random.default_rng([seed, i])
        clips, audio, wavlm = request(rng, b, seq, img)
        anchors = np.stack([np.arange(w * seq + 1, w * seq + seq + 1)
                            for _, _, w in part])
        noise = 0.2 * rng.normal(size=(2,) + anchors.shape)
        lv = np.clip(np.sin(anchors / 40.0) + noise[0], -1, 1)
        la = np.clip(np.cos(anchors / 55.0) + noise[1], -1, 1)
        lv[rng.random(anchors.shape) < 0.05] = -5.0
        yield SimpleNamespace(
            clips=clips, audio=audio, wavlm=wavlm, anchors=anchors,
            videos=[p[0] for p in part], lengths=[p[1] for p in part],
            labels_v=lv.astype(np.float32), labels_a=la.astype(np.float32),
            n_real=n_real)


def phase_stitched_eval(trained) -> None:
    """``validate`` (make_eval_step over the ordered windows, Stitcher,
    scores) on the trained state's weights: card f32 against CPU f32 at 32
    px clips (the I3D stem fold at 64) over the first video's 31 windows,
    CCC V and A within 1e-3; then the trained bf16 flagship itself at 112
    px on the card over both videos' 65, timed."""
    from jmt_tpu_torch.eval import stitch
    from jmt_tpu_torch.train import loops
    sd = trained.model.state_dict()
    scores = {}
    with full_fp32():
        for name, dev in (("card_f32", None), ("cpu_f32", "cpu")):
            cfg = dict(FLAGSHIP_CONFIG, i3d_fused_inception=True,
                       i3d_input_size=64)
            model = make_model(cfg, None)
            model.load_state_dict(sd)
            state = loops.init_state(model, train_config(cfg), device=dev)
            step = loops.make_eval_step(model, device=dev)
            t0 = time.perf_counter()
            scores[name] = stitch.validate(
                step, state, stitch_batches(3, img=32,
                                            videos=STITCH_VIDEOS[:1]))
            emit({"phase": "stitched_eval", "run": name, "img": 32,
                  "ccc_v": scores[name][0], "ccc_a": scores[name][1],
                  "seconds": time.perf_counter() - t0})
    delta = max(abs(x - y) for x, y in zip(scores["card_f32"],
                                           scores["cpu_f32"]))
    if not (delta <= 1e-3 and all(np.isfinite(scores["card_f32"]))):
        raise AssertionError(f"stitched CCC card f32 {scores['card_f32']} "
                             f"vs CPU f32 {scores['cpu_f32']}")
    step = loops.make_eval_step(trained.model)
    t0 = time.perf_counter()
    (ccc_v, ccc_a), launches = counted(
        lambda: stitch.validate(step, trained, stitch_batches(4, img=112)))
    emit({"phase": "stitched_eval", "run": "card_bf16", "img": 112,
          "ccc_v": ccc_v, "ccc_a": ccc_a,
          "seconds": time.perf_counter() - t0,
          "card_f32_vs_cpu_f32_ccc_delta": delta, **launches})
    windows = sum(-(-length // TRAIN_S) for _, length in STITCH_VIDEOS)
    forwards = -(-windows // TRAIN_B)
    expected = {k: v * forwards for k, v in PER_FORWARD["flagship"].items()}
    if launches != expected or not np.isfinite([ccc_v, ccc_a]).all():
        raise AssertionError(f"stitched eval bf16: launches {launches} "
                             f"(expected {expected}), CCC {ccc_v}, {ccc_a}")


# ---------------------------------------------------------------------------
# the trainer entry point: ``python -m jmt_tpu_torch.cli``, in-process
# ---------------------------------------------------------------------------
CLI_SYNTHETIC = "2:530"
CLI_EXPS = "build/chip_exps"
FLAGSHIP_FLAGS = ("--l_vision_backbones", "R2D1+I3D",
                  "--l_audio_backbones", "ResNet18+wavLM",
                  "--intra_modal_fusion", "encoder_plus_self_attention",
                  "--output_format", "SELF_ATTEN",
                  "--i3d_fused_inception", "True")
# the SavedWeights components of the flagship
FLAGSHIP_COMPONENTS = ("all_backbones", "audio_resnet18", "vision_r2d1",
                       "vision_i3d", "fusion_w",
                       "transformer_audio_modality_fusion",
                       "transformer_visio_modality_fusion")
# the K2 launches of one forward of config.json's model (FC head, no
# intra-modal fusion: 3 encoders, 3 paired cross-attentions) and of NoJR
DEFAULT_PER_FORWARD = dict(_NONE, log_mel=1, fused_attention=6)
NOJR_PER_FORWARD = dict(_NONE, log_mel=1, fused_attention=4)
FC_PER_FORWARD = dict(_NONE, log_mel=1)
# batch rows of NoJR's forwards past K2's short path (128)
NOJR_ROWS = (129, 300)


def cli_argv(outd: str, *flags: str, epochs: int = 2) -> list:
    """``--config config.json --synthetic 2:530`` with ``flags``, batch 8
    for every split, ``epochs`` epochs, into ``outd``."""
    return ["--config", "config.json", "--synthetic", CLI_SYNTHETIC, *flags,
            "--train_params__batch_size", "8",
            "--val_params__batch_size", "8",
            "--test_params__batch_size", "8", "--max_epochs", str(epochs),
            "--verbose", "False", "--outd", outd]


def run_cli(argv: list) -> tuple:
    """``jmt_tpu_torch.cli.main(argv)`` with the launch counts set to 0
    before it; returns (its last JSON line, the launches, seconds)."""
    import io
    from jmt_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, launches = counted(lambda: cli.main(argv))
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), launches, \
        seconds


def cli_forwards(epochs: int, split: str = "") -> int:
    """Forwards at batch 8 over the synthetic source: of ``epochs`` epochs
    (train steps plus validation forwards), or of one pass over
    ``split``."""
    from jmt_tpu_torch.data.synthetic import synthetic_dataset
    n, length = map(int, CLI_SYNTHETIC.split(":")[:2])

    def batches(name):
        return -(-len(synthetic_dataset(name, n, length,
                                        check_coverage=False)) // 8)

    return batches(split) if split else \
        epochs * (batches("train") + batches("val"))


def expect_launches(what: str, launches: dict, per_forward: dict,
                    forwards: int) -> None:
    want = {k: v * forwards for k, v in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{what}: expected launches {want} "
                             f"({forwards} forwards), got {launches}")


def epoch_records(exp: str) -> list:
    """The per-epoch metrics records of the experiment's log.json."""
    out = []
    with open(os.path.join(exp, "log.json")) as f:
        for line in f:
            data = json.loads(line[len("DLLL "):]).get("data")
            if isinstance(data, dict) and "epoch_seconds" in data:
                out.append(data)
    return out


def fresh(outd: str) -> str:
    import shutil
    shutil.rmtree(outd, ignore_errors=True)
    return os.path.join(outd, "id_exp")


def final_weights(exp: str) -> dict:
    return torch.load(os.path.join(exp, "SavedWeights", "train_state.pt"),
                      map_location="cpu", weights_only=True)["model"]


def phase_cli_train() -> str:
    """The flagship through the CLI for two epochs: launches (1 K1, 12
    K2, 9 K3 per step and per validation forward), the experiment files,
    each epoch's timings; then the same command again, a no-op."""
    exp = fresh(CLI_EXPS)
    argv = cli_argv(CLI_EXPS, *FLAGSHIP_FLAGS)
    out, launches, seconds = run_cli(argv)
    forwards = cli_forwards(2)
    emit({"phase": "cli_train", "seconds": seconds, "forwards": forwards,
          **out, **launches})
    for rec in epoch_records(exp):
        emit({"phase": "cli_train_epoch", **rec})
    expect_launches("cli_train", launches, PER_FORWARD["flagship"], forwards)
    missing = [p for p in ([os.path.join("SavedWeights", f"{n}.pt")
                            for n in FLAGSHIP_COMPONENTS + ("train_state",)]
                           + ["final_config.yml", "perfs.yml", "passed.txt"])
               if not os.path.isfile(os.path.join(exp, p))]
    if missing or len(epoch_records(exp)) != 2:
        raise AssertionError(f"cli_train: missing {missing}")
    state = os.path.join(exp, "SavedWeights", "train_state.pt")
    mtime = os.stat(state).st_mtime_ns
    again, launches, seconds = run_cli(argv)
    emit({"phase": "cli_train_again", "seconds": seconds, **again,
          **launches})
    if again != {"best": {}} or any(launches.values()) \
            or os.stat(state).st_mtime_ns != mtime:
        raise AssertionError(f"cli_train again: {again}, {launches}")
    return exp


def phase_cli_resume(trained: str) -> None:
    """The same command with ``--preempt_save_steps 3``, preempted in its
    second step of epoch 0: it saves at step 3 and exits without
    passed.txt; the same command again resumes there and ends where
    ``cli_train`` ended, bit for bit (the largest |delta| of the final
    weights is 0)."""
    from jmt_tpu_torch.core import preempt
    from jmt_tpu_torch.train import runner as runner_mod
    outd = CLI_EXPS + "_resume"
    exp = fresh(outd)
    argv = cli_argv(outd, *FLAGSHIP_FLAGS, "--preempt_save_steps", "3")
    make_step = runner_mod.make_train_step

    def preempting(model, **kw):
        step, calls = make_step(model, **kw), []

        def call(*args, **kwargs):
            out = step(*args, **kwargs)
            calls.append(1)
            if len(calls) == 2:
                preempt.request()
            return out
        return call

    runner_mod.make_train_step = preempting
    try:
        out, launches, seconds = run_cli(argv)
    finally:
        runner_mod.make_train_step = make_step
        preempt.clear()
    cut = {f: os.path.isfile(os.path.join(exp, f))
           for f in ("preempted.txt", "passed.txt")}
    emit({"phase": "cli_resume_preempted", "seconds": seconds, **out,
          **cut, **launches})
    if cut != {"preempted.txt": True, "passed.txt": False}:
        raise AssertionError(f"cli_resume: the preempted run left {cut}")
    expect_launches("cli_resume preempted", launches,
                    PER_FORWARD["flagship"], 3)
    out, launches, seconds = run_cli(argv)
    got, want = final_weights(exp), final_weights(trained)
    delta = max(float((got[k].double() - want[k].double()).abs().max())
                for k in want if want[k].is_floating_point())
    emit({"phase": "cli_resume", "seconds": seconds,
          "final_weights_max_abs_delta_vs_cli_train": delta,
          "passed": os.path.isfile(os.path.join(exp, "passed.txt")),
          **out, **launches})
    if not (delta == 0.0 and os.path.isfile(os.path.join(exp,
                                                         "passed.txt"))):
        raise AssertionError(f"cli_resume: final weights {delta} from "
                             f"cli_train's, not bitwise")


def phase_cli_eval(exp: str) -> None:
    """Eval mode on ``cli_train``'s directory: the components reproduce
    the best epoch's valid CCC, the state the last epoch's (within 1e-3,
    the stitched-eval bound); the test split writes a ``{vid}.txt`` per
    video."""
    with open(os.path.join(exp, "perfs.yml")) as f:
        perfs = json.load(f)
    want = {"components": (perfs["best"]["valid_v"],
                           perfs["best"]["valid_a"]),
            "state": (perfs["tracker"]["valid_v"][-1],
                      perfs["tracker"]["valid_a"][-1])}
    forwards = cli_forwards(0, "val")
    common = ["--mode", "Eval", "--exp-dir", exp, "--synthetic",
              CLI_SYNTHETIC]
    for weights, (v, a) in want.items():
        out, launches, seconds = run_cli(common + ["--eval-weights",
                                                   weights])
        delta = max(abs(out["valid_ccc_v"] - v), abs(out["valid_ccc_a"] - a))
        emit({"phase": "cli_eval", "weights": weights, "seconds": seconds,
              **out, "want_v": v, "want_a": a, "max_abs_delta": delta,
              **launches})
        expect_launches(f"cli_eval {weights}", launches,
                        PER_FORWARD["flagship"], forwards)
        if not delta <= 1e-3:
            raise AssertionError(f"cli_eval {weights}: {out} vs {(v, a)}")
    out, launches, seconds = run_cli(common + ["--eval-split", "test"])
    txts = sorted(os.listdir(out["test_predictions_dir"]))
    lines = [len(open(os.path.join(out["test_predictions_dir"], t)
                      ).read().splitlines()) for t in txts]
    emit({"phase": "cli_eval", "split": "test", "seconds": seconds,
          "files": txts, "lines": lines, **launches})
    expect_launches("cli_eval test", launches, PER_FORWARD["flagship"],
                    cli_forwards(0, "test"))
    if txts != ["synth000.txt", "synth001.txt"] or lines != [531, 531]:
        raise AssertionError(f"cli_eval test: {txts}, {lines}")


# ---------------------------------------------------------------------------
# cli_files_pretrained: the recipe of record from files (pretrained
# backbones, an Affwild2-layout tree, native decode)
# ---------------------------------------------------------------------------
FILES_ROOT = os.path.abspath("build/chip_files")
# (split directory, video, frames) of the tree: 16 train steps at batch 8
# (64 windows a 1,300-frame video), so the epoch's loader-wait share is
# not one warm-up step's
FILES_VIDEOS = (("Train_Set", "files_a", 1300), ("Train_Set", "files_b", 1300),
                ("Val_Set", "files_c", 530))
FILES_INIT = ("--init_w_R2D1", "AFFWILD2", "--init_w_ResNet18", "IMAGENET",
              "--init_w_I3D", "AFFWILD2")
FILES_WAV_SAMPLES = 30000


def pretrained_files(root: str, seed: int = 21) -> dict:
    """Seeded backbone weights written under ``root`` in the reference's
    layouts of the recipe's sources: R2D1 AFFWILD2 (a VideoModel state
    dict with a 4-channel stem and its 17-way ``fc``), ResNet-18 IMAGENET
    (torchvision's, RGB ``conv1`` and the 1000-way ``fc``), I3D AFFWILD2
    (``{'net': sd}`` with ``module.`` prefixes and the I3D_WSDDA's heads,
    the trunk's ``logits`` among them: the port drops that head, where
    the JAX package refuses such a file, ``ROADMAP.md`` §C.4).
    Returns, per component, what its module must hold after the load
    (its state-dict keys, BN's ``num_batches_tracked`` aside)."""
    from jmt_tpu_torch.models.common import init_parameters
    from jmt_tpu_torch.models.convert import synthesize_dead_keys
    from jmt_tpu_torch.models.tsav import TwoStreamBackbones
    src = init_parameters(TwoStreamBackbones(
        vision_backbones=("R2D1", "I3D"), audio_backbones=("ResNet18",)),
        torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)

    def tensors(sd):
        return {k: torch.as_tensor(v) for k, v in sd.items()}

    def kept(sd, prefix=""):
        return {prefix + k: v.clone() for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}

    os.makedirs(root, exist_ok=True)
    r2d1 = src.vision_r2d1.r2plus1d.state_dict()
    want = {"vision_r2d1": kept(r2d1, "r2plus1d.")}
    file_sd = {f"r2plus1d.{k}": v for k, v in r2d1.items()}
    stem = r2d1["stem.0.weight"]
    file_sd["r2plus1d.stem.0.weight"] = torch.cat(
        [stem, torch.randn(stem.shape[0], 1, *stem.shape[2:],
                           generator=gen)], dim=1)
    torch.save(tensors(synthesize_dead_keys("vision_r2d1", file_sd)),
               os.path.join(root, "vision_TSAV_Sub4_544k.pt"))
    rn = dict(src.audio_resnet18.resnet.state_dict())
    rn["conv1.weight"] = torch.randn(64, 3, 7, 7, generator=gen) * 0.1
    want["audio_resnet18"] = kept(rn, "resnet.")
    want["audio_resnet18"]["resnet.conv1.weight"] = torch.from_numpy(
        rn["conv1.weight"].numpy().mean(axis=1, keepdims=True))
    rn["fc.weight"] = torch.randn(1000, 512, generator=gen) * 0.01
    rn["fc.bias"] = torch.zeros(1000)
    torch.save(rn, os.path.join(root, "resnet18-f37072fd.pth"))
    i3d = src.vision_i3d.state_dict()
    want["vision_i3d"] = kept(i3d)
    torch.save({"net": {f"module.{k}": v for k, v in tensors(
        synthesize_dead_keys("vision_i3d", i3d)).items()}},
        os.path.join(root, "Val_model_valence_cnn_lstm_mil_64_new.t7"))
    return want


def files_tree(root: str, jpeg: bool) -> dict:
    """An Affwild2-layout tree under ``root``, made with the port's
    preprocessing tools: VA txt annotations turned into label CSVs
    (``convert_va_annotations``), realtimestamps (``write_realtimestamps``),
    per-frame wavLM features from per-video CSVs
    (``explode_wavlm_features``), a PCM16 wav per frame (``wave``), and the
    frames: the committed JPEG fixtures copied cyclically, or with
    ``jpeg`` False (a host that can decode no JPEG) the same fixtures'
    seeded source images as raw .npy (decoded by nothing). Returns the
    config's dataset flags."""
    import shutil
    import wave
    from jmt_tpu_torch.data import preprocessing as prep
    from jmt_tpu_torch.tools import jpeg_fixtures
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(13)
    fixtures = jpeg_fixtures.paths()
    d = {k: os.path.join(root, k) for k in (
        "txt", "annotations", "ts", "wavs", "wavlm_csv", "wavlm", "frames")}
    os.makedirs(os.path.join(d["annotations"], "Test_Set"))
    for split, video, n in FILES_VIDEOS:
        txt = os.path.join(d["txt"], split)
        os.makedirs(txt, exist_ok=True)
        va = rng.uniform(-1, 1, (n, 2))
        with open(os.path.join(txt, f"{video}.txt"), "w") as f:
            f.write("valence,arousal\n")
            f.writelines(f"{v:.3f},{a:.3f}\n" for v, a in va)
        prep.convert_va_annotations(txt, os.path.join(d["annotations"],
                                                      split))
        prep.write_realtimestamps(d["ts"], video, n)
        os.makedirs(d["wavlm_csv"], exist_ok=True)
        with open(os.path.join(d["wavlm_csv"], f"{video}.csv"), "w") as f:
            f.write(",".join(map(str, range(768))) + "\n")
            for row in rng.normal(size=(n, 768)).astype(np.float32):
                f.write(",".join(f"{x:.6f}" for x in row) + "\n")
        os.makedirs(os.path.join(d["frames"], video))
        os.makedirs(os.path.join(d["wavs"], video))
        for i in range(1, n + 1):
            stem = os.path.join(d["frames"], video, f"{i:05d}")
            if jpeg:
                shutil.copyfile(fixtures[i % len(fixtures)], stem + ".jpg")
            else:
                np.save(stem + ".npy", jpeg_fixtures.image(i % len(fixtures)))
            pcm = (rng.normal(size=FILES_WAV_SAMPLES) * 3000).astype("<i2")
            with wave.open(os.path.join(d["wavs"], video, f"{i}.wav"),
                           "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(44100)
                w.writeframes(pcm.tobytes())
    prep.explode_wavlm_features(d["wavlm_csv"], d["wavlm"])
    return {"frames": d["frames"], "wavs": d["wavs"],
            "flags": ("--dataset_annotations", d["annotations"],
                      "--dataset_wavspath", d["wavs"],
                      "--dataset_realtimestamps", d["ts"],
                      "--wavlm_features", d["wavlm"])}


def npy_frame(path: str):
    """The raw .npy frame stored beside the label CSV's .jpg name."""
    p = os.path.splitext(path)[0] + ".npy"
    return np.load(p) if os.path.exists(p) else None


def jpeg_headers() -> tuple:
    """Whether this host's g++ finds libjpeg's header, which the native
    library's JPEG half needs (``#include <jpeglib.h>`` through the
    preprocessor), with the preprocessor's messages and the libjpeg
    entries of ``ldconfig -p``."""
    import subprocess
    proc = subprocess.run(["g++", "-x", "c++", "-E", "-"],
                          input="#include <jpeglib.h>\n",
                          capture_output=True, text=True)
    try:
        ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True,
                                  text=True).stdout
    except OSError as e:
        ldconfig = str(e)
    return (proc.returncode == 0, proc.stderr.strip(),
            [ln.strip() for ln in ldconfig.splitlines() if "libjpeg" in ln])


def check_native_decode(tree: dict, frames: str) -> dict:
    """The decoders on the tree, every file: the wavs through the native
    library (its WAV functions) against the Python loader's left-padded
    decode (bitwise), and the frames through the decoder the epoch uses
    (``frames``: the native library, or PIL where its JPEG half cannot
    build here) against the fixtures' seeded images (mean |delta| below 8
    grey levels at quality 90); files a second each."""
    from jmt_tpu_torch.data import native
    from jmt_tpu_torch.data.audio_io import load_wav
    from jmt_tpu_torch.data.datasets import _fit_audio, default_frame_loader
    from jmt_tpu_torch.ops.mel import AUDIO_SAMPLES
    from jmt_tpu_torch.tools import jpeg_fixtures
    wavs = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(tree["wavs"])
                  for f in fs)
    native.decode_wav_batch(wavs[:8], AUDIO_SAMPLES)  # build and load
    t0 = time.perf_counter()
    got = native.decode_wav_batch(wavs, AUDIO_SAMPLES)
    wav_s = time.perf_counter() - t0
    want = np.stack([_fit_audio(load_wav(p), AUDIO_SAMPLES) for p in wavs])
    rec = {"wavs": len(wavs), "wav_files_per_s": len(wavs) / wav_s,
           "wav_equal_python_decode": bool(np.array_equal(got, want))}
    if not rec["wav_equal_python_decode"]:
        raise AssertionError(f"native WAV decode: {rec}")
    if frames == "npy":
        return rec
    paths = sorted(os.path.join(dp, f)
                   for dp, _, fs in os.walk(tree["frames"]) for f in fs)
    if frames == "native":
        def decode(ps):
            return native.decode_jpeg_batch(ps, 112, 112)
    else:
        def decode(ps):
            return np.stack([default_frame_loader(p)[:112, :112]
                             for p in ps])
    decode(paths[:8])
    t0 = time.perf_counter()
    imgs = decode(paths)
    rec.update(frame_files=len(paths), frame_decoder=frames,
               frames_per_s=len(paths) / (time.perf_counter() - t0))
    n = len(jpeg_fixtures.paths())
    rec["frames_mean_abs_vs_source"] = max(
        float(np.abs(img.astype(int) - jpeg_fixtures.image(
            int(os.path.basename(p)[:5]) % n)).mean())
        for img, p in zip(imgs, paths))
    if not rec["frames_mean_abs_vs_source"] < 8:
        raise AssertionError(f"{frames} JPEG decode: {rec}")
    return rec


def phase_cli_files_pretrained() -> None:
    """The flagship recipe of record from files: pretrained R2D1
    (AFFWILD2), ResNet-18 (IMAGENET) and I3D (AFFWILD2) files in the
    reference's layouts, an Affwild2-layout tree made by the preprocessing
    tools, and ``python -m jmt_tpu_torch.cli`` (``cli.main`` in this
    process, its default loaders) for one epoch on the card, frozen
    backbones. The native library builds from ``native/jmt_dataio.cc``
    into ``build/``, and a failed build fails the phase, unless libjpeg's
    header is missing on the host (``jpeg_headers``): then a line gives
    the preprocessor's message, the library's WAV half is built (or the
    phase fails), the dataset decodes its wavs with it and its JPEG frames
    with PIL; a host without PIL either gets raw .npy frames through
    ``npy_frame``, marked in every record. Asserted: 1 K1, 12 K2, 9 K3 a
    forward; the dataset's native decode as the host allows it; the
    backbones after ``Runner.initialize`` equal the files bitwise (the
    transforms applied), frozen, and still equal them after the epoch;
    the native WAV decode equals the Python one."""
    import functools
    import importlib.util
    from jmt_tpu_torch import cli
    from jmt_tpu_torch.data import native
    from jmt_tpu_torch.train import runner as runner_mod
    headers, probe, ldconfig = jpeg_headers()
    native.load(jpeg=headers)  # raises with the compiler's output
    emit({"phase": "native_build", "jpeg": headers,
          "library": str(native.library_path(headers)),
          "why_no_jpeg": None if headers else probe,
          "ldconfig_libjpeg": ldconfig})
    if headers:
        frames = "native"
    elif importlib.util.find_spec("PIL") is not None:
        frames = "pil"
    else:
        frames = "npy"
    marks = {"native": "jpeg, native decode; wavs native",
             "pil": "jpeg, PIL decode (no libjpeg header here for the "
                    "native JPEG half); wavs native (the library's WAV "
                    "half)",
             "npy": "raw .npy of the fixtures' source images (no JPEG "
                    "decoded: no libjpeg header and no PIL here); wavs "
                    "native (the library's WAV half)"}[frames]
    tree = files_tree(FILES_ROOT, frames != "npy")
    weights = os.path.join(FILES_ROOT, "pretrained")
    want = pretrained_files(weights)
    emit({"phase": "native_decode", "frames": marks,
          **check_native_decode(tree, frames)})
    outd = os.path.join(FILES_ROOT, "exps")
    exp = fresh(outd)
    argv = ["--config", os.path.abspath("config.json"), *FLAGSHIP_FLAGS,
            *FILES_INIT, "--pretrained_weights_dir", weights,
            *tree["flags"], "--train_params__batch_size", "8",
            "--val_params__batch_size", "8", "--test_params__batch_size",
            "8", "--max_epochs", "1", "--verbose", "False", "--outd", outd]
    kw = {"frame_loader": npy_frame} if frames == "npy" else {}
    cfg = cli.build_config(cli.parse_args(argv))
    train, val, _, _ = cli.make_datasets(cfg, **kw)
    forwards = -(-len(train) // 8) + -(-len(val) // 8)
    loaded = {}
    initialize, make_datasets = runner_mod.Runner.initialize, \
        cli.make_datasets

    def initialize_and_read(self):
        initialize(self)
        for comp in want:
            mod = getattr(self.model.backbones, comp)
            loaded[comp] = ({k: v.detach().cpu().clone()
                             for k, v in mod.state_dict().items()},
                            any(p.requires_grad for p in mod.parameters()))
        loaded["native"] = {"frames": self.train_ds.use_native,
                            "wavs": self.train_ds.native_wavs}

    runner_mod.Runner.initialize = initialize_and_read
    if kw:
        cli.make_datasets = functools.partial(make_datasets, **kw)
    cwd = os.getcwd()
    os.chdir(tree["frames"])  # the label CSVs name frames video/NNNNN.jpg
    try:
        out, launches, seconds = run_cli(argv)
    finally:
        os.chdir(cwd)
        runner_mod.Runner.initialize = initialize
        cli.make_datasets = make_datasets
    final = final_weights(exp)
    report = {}
    for comp, sd in want.items():
        got, trainable = loaded[comp]
        report[comp] = {
            "loaded_differ": [k for k in sd if not torch.equal(got[k], sd[k])],
            "trainable": trainable,
            "after_epoch_differ": [
                k for k in sd
                if not torch.equal(final[f"backbones.{comp}.{k}"], sd[k])]}
    records = epoch_records(exp)
    emit({"phase": "cli_files_pretrained", "frames": marks,
          "native_decode": loaded["native"], "seconds": seconds,
          "forwards": forwards, "train_windows": len(train),
          "val_windows": len(val), "backbones": report, **out,
          **launches})
    for rec in records:
        emit({"phase": "cli_files_pretrained_epoch", "frames": marks,
              **rec})
    expect_launches("cli_files_pretrained", launches,
                    PER_FORWARD["flagship"], forwards)
    bad = {c: r for c, r in report.items()
           if r["loaded_differ"] or r["trainable"] or r["after_epoch_differ"]}
    if loaded["native"] != {"frames": headers, "wavs": True}:
        bad["native_decode"] = loaded["native"]
    if bad or len(records) != 1:
        raise AssertionError(f"cli_files_pretrained: {bad}, "
                             f"{len(records)} epoch records")


# ---------------------------------------------------------------------------
# serve: a trained experiment behind one CUDA graph per bucket, raw audio,
# the extractor and a streaming session
# ---------------------------------------------------------------------------
SERVE_REQUESTS = (1, 3, 8, 11)
WAVLM_CKPT = "build/chip_wavlm/wavlm_base_plus_seed0.pt"
# relative bound of the card's WavLM features, as they run, against CPU
# f32
WAVLM_REL_TOL = 1e-4


def eager_latency(server, b: int, iters: int = 10, warmup: int = 2
                  ) -> tuple:
    """The eager path's p50/p90 beside ``measure_latency``'s two ways:
    ``eager_predict`` end to end, and the eager forward of inputs already
    on the card plus a scalar read."""
    req = request(np.random.default_rng(0), b, server.seq)
    arrays = {k: torch.from_numpy(x).cuda()
              for k, x in zip(REQUEST_KEYS, req)}

    def resident(*_):
        v, _ = server.forward(arrays)
        float(v.float().sum())

    return tuple(dict(request_latency(fn, req, iters, warmup),
                      device_input=device_input)
                 for device_input, fn in (
                     (False, lambda *r: eager_predict(server, r)),
                     (True, resident)))


def write_wavlm_checkpoint() -> str:
    """wavlm-base-plus geometry, 12 layers, seed-0 random weights (Hugging
    Face's initializers), saved as a Hugging Face state dict."""
    from jmt_tpu_torch.models import wavlm
    os.makedirs(os.path.dirname(WAVLM_CKPT), exist_ok=True)
    model = wavlm.init_parameters(wavlm.WavLMModel(),
                                  torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), WAVLM_CKPT)
    return WAVLM_CKPT


def check_wavlm(frontend, audio: np.ndarray) -> None:
    """The frontend on a bucket-8 request's chunks: host resample ms and
    WavLM device ms apart (CUDA events), and its features as it runs
    (the process's flags; WavLM's own convs with TF32 off,
    ``models/wavlm.full_fp32_convs``) against the same checkpoint's WavLM
    on the CPU in f32; beside them the same with that guard taken out
    (cuDNN's default TF32 convs): its error and its device ms, the cost
    of the guard."""
    from jmt_tpu_torch.data.wavlm_extract import load_torch_checkpoint
    from jmt_tpu_torch.models import wavlm
    resample_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        w16 = frontend.resample(audio)
        resample_ms.append((time.perf_counter() - t0) * 1e3)
    card = frontend.embed(w16).cpu().numpy()
    device_ms = time_ms(lambda: frontend.embed(w16), iters=5, warmup=1)
    guard = wavlm.full_fp32_convs
    wavlm.full_fp32_convs = contextlib.nullcontext
    try:
        card_tf32 = frontend.embed(w16).cpu().numpy()
        tf32_ms = time_ms(lambda: frontend.embed(w16), iters=5, warmup=1)
    finally:
        wavlm.full_fp32_convs = guard
    cpu_model, cfg = load_torch_checkpoint(WAVLM_CKPT)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu_model(torch.from_numpy(w16))[:, -1].numpy()
    cpu_s = time.perf_counter() - t0
    rel = float(np.abs(card - ref).max() / np.abs(ref).max())
    rel_tf32 = float(np.abs(card_tf32 - ref).max() / np.abs(ref).max())
    frames = cfg.n_frames(w16.shape[1])
    # per layer and token: 4 E^2 projections, 2 E F MLP, 2 T E scores
    # and mix, each a multiply-add
    t, e, f = frames, cfg.hidden_size, cfg.intermediate_size
    layers = 2 * t * (4 * e * e + 2 * e * f + 2 * t * e) \
        * cfg.num_hidden_layers
    n = w16.shape[1]
    conv = 0
    dims = (1,) + tuple(cfg.conv_dim)
    for i, (k, st) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
        n = (n - k) // st + 1
        conv += 2 * n * dims[i] * dims[i + 1] * k
    pos = 2 * t * e * (e // cfg.num_conv_pos_embedding_groups) \
        * cfg.num_conv_pos_embeddings
    flops = w16.shape[0] * (layers + conv + pos + 2 * t * 512 * e)
    bound_ms, bound_by = bound(w16.nbytes + card.nbytes, flops,
                               F32_PEAK_FLOPS)
    emit({"phase": "serve_wavlm", "chunks": int(w16.shape[0]),
          "samples_16k": int(w16.shape[1]), "frames": frames,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "resample_ms": resample_ms, "device_ms": device_ms,
          "device_ms_tf32_convs": tf32_ms,
          "tflop": flops / 1e12, "bound_ms": bound_ms, "bound_by": bound_by,
          "cpu_f32_seconds": cpu_s, "card_vs_cpu_f32_rel": rel,
          "card_tf32_convs_vs_cpu_f32_rel": rel_tf32})
    if not (np.isfinite(card).all() and rel <= WAVLM_REL_TOL):
        raise AssertionError(f"WavLM card (as served) vs CPU f32: {rel} of "
                             f"max |ref| (limit {WAVLM_REL_TOL})")


def check_extractor(frontend) -> None:
    """``WavLMExtractor.per_frame`` over a 30 s synthetic wav at 30 fps
    (20 s windows, 2 s overlap), under the process's flags: its frame
    count, seconds per audio second, and its features against the same
    checkpoint's extractor on the CPU in f32 (within ``WAVLM_REL_TOL`` of
    max |ref|)."""
    from jmt_tpu_torch.data.wavlm_extract import (WavLMExtractor,
                                                  load_torch_checkpoint)
    ex = WavLMExtractor(frontend.model)
    t = np.arange(30 * 16000) / 16000
    rng = np.random.default_rng(4)
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * rng.normal(size=t.shape)).astype(np.float32)
    ex.per_frame(wav[:16000], 30, 30.0)  # the 20 s window's first forward
    t0 = time.perf_counter()
    feats = ex.per_frame(wav, 900, 30.0)
    seconds = time.perf_counter() - t0
    cpu_model, _ = load_torch_checkpoint(WAVLM_CKPT)
    t0 = time.perf_counter()
    ref = WavLMExtractor(cpu_model, device="cpu").per_frame(wav, 900,
                                                           30.0)
    cpu_s = time.perf_counter() - t0
    rel = float(np.abs(feats - ref).max() / np.abs(ref).max())
    emit({"phase": "serve_extractor", "frames": int(feats.shape[0]),
          "seconds": seconds, "seconds_per_audio_second": seconds / 30,
          "cpu_f32_seconds": cpu_s, "card_vs_cpu_f32_rel": rel})
    if feats.shape != (900, 768) or not np.isfinite(feats).all() \
            or not rel <= WAVLM_REL_TOL:
        raise AssertionError(f"extractor: {feats.shape}, card vs CPU f32 "
                             f"{rel} of max |ref| (limit {WAVLM_REL_TOL})")


def check_streaming(server) -> None:
    """A StreamingSession over the ordered windows of two synthetic
    videos, fed one batch (its real rows) at a time through the graphs,
    against the stitched, smoothed traces of ``eval/stitch.Stitcher`` over
    the same windows through the eager forward."""
    from jmt_tpu_torch.eval.stitch import Stitcher
    from jmt_tpu_torch.serve import StreamingSession
    session = StreamingSession(server)
    stitcher = Stitcher(with_labels=False)
    t0 = time.perf_counter()
    for batch in stitch_batches(6, img=112):
        n = batch.n_real
        session.feed(batch.clips[:n], batch.audio[:n], batch.wavlm[:n],
                     batch.anchors[:n], batch.videos[:n], batch.lengths[:n])
        v, a = eager_predict(server, (batch.clips, batch.audio,
                                      batch.wavlm))
        stitcher.add_batch(v, a, batch.anchors, batch.videos,
                           batch.lengths, n_real=n)
    seconds = time.perf_counter() - t0
    traces = session.finish_all()
    sv, sa = stitcher.smoothed()
    delta = max(max(float(np.abs(traces[vid][0] - sv[vid]).max()),
                    float(np.abs(traces[vid][1] - sa[vid]).max()))
                for vid in sv)
    emit({"phase": "serve_streaming", "videos": sorted(traces),
          "frames": [len(traces[vid][0]) for vid in sorted(traces)],
          "seconds": seconds, "stream_vs_stitch_max_abs": delta})
    if sorted(traces) != sorted(sv) or not delta <= STREAM_TOL_BF16:
        raise AssertionError(f"streaming against stitching: {delta}")


def phase_serve(exp: str) -> None:
    """``InferenceServer.from_experiment`` on ``cli_train``'s directory:
    capture seconds and launches per bucket's graph (asserted), requests
    against the eager forward, ``measure_latency`` both ways beside the
    eager path, a profiled replay per bucket, peak memory; then raw audio
    through a WavLM base+ frontend, the extractor and a streaming
    session."""
    from jmt_tpu_torch.serve import (InferenceServer, WavLMFrontend,
                                     measure_latency)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = InferenceServer.from_experiment(exp, buckets=(1, 8))
    emit({"phase": "serve_build", "seconds": time.perf_counter() - t0})
    expect_captures("flagship", server)
    rng = np.random.default_rng(11)
    for n in SERVE_REQUESTS:
        req = request(rng, n, 16)
        got = server.predict(*req)
        delta = va_max_abs(got, eager_predict(server, req))
        emit({"phase": "serve_request", "n": n,
              "replay_vs_eager_va_max_abs": delta})
        if not (got[0].shape == (n, 16) and np.isfinite(got).all()
                and delta == 0.0):
            raise AssertionError(f"serve request {n}: {delta}")
    for b in (1, 8):
        for device_input in (False, True):
            emit({"phase": "serve_latency", "mode": "graph",
                  **measure_latency(server, b, iters=10,
                                    device_input=device_input)})
        for rec in eager_latency(server, b):
            emit({"phase": "serve_latency", "mode": "eager", **rec})
        profile_replay("serve", server, b)
    emit({"phase": "serve_memory",
          "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    del server
    torch.cuda.empty_cache()

    frontend = WavLMFrontend.from_checkpoint(write_wavlm_checkpoint())
    check_wavlm(frontend, request(rng, 8, 16)[1])
    server = InferenceServer.from_experiment(exp, buckets=(1, 8),
                                             wavlm_frontend=frontend)
    clips, audio, _ = request(rng, 3, 16)
    raw = server.predict(clips, audio)
    given = server.predict(clips, audio, frontend.features(
        np.concatenate([audio, np.zeros((5,) + audio.shape[1:],
                                        np.float32)]))[:3])
    emit({"phase": "serve_raw_audio", "n": 3,
          "raw_vs_given_features_va_max_abs": va_max_abs(raw, given)})
    if not va_max_abs(raw, given) <= STREAM_TOL_BF16:
        raise AssertionError("raw-audio predict against predict given "
                             "the frontend's features")
    for b, iters in ((1, 8), (8, 4)):
        emit({"phase": "serve_latency", "mode": "graph_raw_audio",
              **measure_latency(server, b, iters=iters, warmup=1)})
    check_extractor(frontend)
    check_streaming(server)
    del server, frontend
    torch.cuda.empty_cache()


def phase_cli_default_config() -> None:
    """config.json's own model (R2D1 + ResNet18, FC head, bf16) through
    the CLI for one epoch; then one eval forward each of the NoJR and the
    FeatureConcatFC configurations, card f32 (TF32 off) against CPU f32,
    and NoJR over 129 and 300 rows (``check_nojr_rows``)."""
    from jmt_tpu_torch import cli
    from jmt_tpu_torch.models.common import init_parameters
    from jmt_tpu_torch.models.jmt_model import model_from_config
    from jmt_tpu_torch.train.loops import eval_forward
    outd = CLI_EXPS + "_default"
    exp = fresh(outd)
    out, launches, seconds = run_cli(cli_argv(outd, epochs=1))
    emit({"phase": "cli_default_config", "seconds": seconds, **out,
          **launches})
    for rec in epoch_records(exp):
        emit({"phase": "cli_default_config_epoch", **rec})
    expect_launches("cli_default_config", launches, DEFAULT_PER_FORWARD,
                    cli_forwards(1))
    rng = np.random.default_rng(7)
    clips, audio, _ = request(rng, 3, 4)
    arrays = {"clips": torch.from_numpy(clips),
              "audio": torch.from_numpy(audio)}
    with full_fp32():
        for joint, per_forward in (("NONE", NOJR_PER_FORWARD),
                                   ("FC", FC_PER_FORWARD)):
            cfg = cli.build_config(cli.parse_args(
                ["--config", "config.json", "--joint_modalities", joint,
                 "--compute_dtype", "float32"]))
            card = init_parameters(model_from_config(cfg),
                                   torch.Generator().manual_seed(3))
            cpu = model_from_config(cfg)
            cpu.load_state_dict(card.state_dict())
            card.cuda()
            got, launches = counted(lambda: eval_forward(
                card, {k: x.cuda() for k, x in arrays.items()}))
            want = eval_forward(cpu, arrays)
            delta = va_max_abs(tuple(x.cpu().numpy() for x in got),
                               tuple(x.numpy() for x in want))
            emit({"phase": "cli_default_config_lattice", "joint": joint,
                  "card_f32_vs_cpu_f32_max_abs": delta,
                  "va_std_cpu": float(want[0].std()), **launches})
            expect_launches(f"joint {joint}", launches, per_forward, 1)
            if not delta <= 1e-3:
                raise AssertionError(f"joint {joint}: card f32 vs CPU f32 "
                                     f"V/A {delta}")
            if joint == "NONE":
                check_nojr_rows(card, cpu, rng)


def check_nojr_rows(card, cpu, rng) -> None:
    """NoJR attends over the batch axis (``encode_batch_axis_quirk``):
    eval forwards of NOJR_ROWS rows (seq 2, 32 px clips) take K2's long
    path; card f32 against CPU f32 within 1e-3 on V/A, 4 K2 launches a
    forward."""
    from jmt_tpu_torch.train.loops import eval_forward
    for rows in NOJR_ROWS:
        clips, audio, _ = request(rng, rows, 2, img=32)
        arrays = {"clips": torch.from_numpy(clips),
                  "audio": torch.from_numpy(audio)}
        got, launches = counted(lambda: eval_forward(
            card, {k: x.cuda() for k, x in arrays.items()}))
        want = eval_forward(cpu, arrays)
        delta = va_max_abs(tuple(x.cpu().numpy() for x in got),
                           tuple(x.numpy() for x in want))
        emit({"phase": "cli_default_config_nojr_rows", "rows": rows,
              "card_f32_vs_cpu_f32_max_abs": delta,
              "va_std_cpu": float(want[0].std()), **launches})
        expect_launches(f"NoJR over {rows} rows", launches,
                        NOJR_PER_FORWARD, 1)
        if not delta <= 1e-3:
            raise AssertionError(f"NoJR over {rows} rows: card f32 vs CPU "
                                 f"f32 V/A {delta}")


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmul and cuDNN, for the f32 comparisons."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def k4_timing(x: torch.Tensor, k: torch.Tensor) -> dict:
    """K4's wrapper on (x, k): CUDA-events ms per call over 20 back-to-back
    calls, device-only ms, and each device operation of one call (name,
    ms; torch.profiler). Uses only ``pool3_1x1``, so it times any tree's
    K4 (``--k4-ab``)."""
    from jmt_tpu_torch.ops.kernels.pool1x1 import pool3_1x1
    ops = launch_ms(lambda: pool3_1x1(x, k), reps=10)
    return {"ms": time_ms(lambda: pool3_1x1(x, k), iters=20, warmup=3),
            "device_ms": sum(ms for _, ms in ops), "device_ops": ops}


def k4_inputs(shape, co: int, gen: torch.Generator):
    """x ~ N(0, 1) (N, T, H, W, C) as (N, C, T, H, W) channels-last and
    k ~ N(0, 0.05^2) (C, co), bf16 on the card."""
    x = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    k = 0.05 * torch.randn(shape[-1], co, device="cuda", generator=gen)
    return x.permute(0, 4, 1, 2, 3), k.to(torch.bfloat16)


def mel_times() -> None:
    """``--mel-times``: K1 of the jmt_tpu_torch in the working directory
    (built from that tree's sources) at N = 16 and 128, one line each."""
    sys.path.insert(0, os.getcwd())
    import jmt_tpu_torch
    gen = torch.Generator().manual_seed(0)
    for n in (16, 128):
        emit({"n": n, "package": os.path.dirname(jmt_tpu_torch.__file__),
              **mel_timing(mel_audio(gen, n))})


def k4_times() -> None:
    """``--k4-times``: K4 of the jmt_tpu_torch in the working directory at
    the TPU tool's six timed shapes (128 clips, bf16), one line each."""
    sys.path.insert(0, os.getcwd())
    import jmt_tpu_torch
    from jmt_tpu_torch.tools.pool1x1_experiment import TIME_SHAPES
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, co in TIME_SHAPES["time"] + TIME_SHAPES["time2"]:
        emit({"shape": list(shape), "co": co,
              "package": os.path.dirname(jmt_tpu_torch.__file__),
              **k4_timing(*k4_inputs(shape, co, gen))})


def k3_times() -> None:
    """``--k3-times``: K3's Mixed_5c launch (avg_tail) of the
    jmt_tpu_torch in the working directory at 128 clips, bf16: CUDA-events
    ms, device-only ms and its device operations."""
    sys.path.insert(0, os.getcwd())
    import jmt_tpu_torch
    from jmt_tpu_torch.models.common import init_parameters
    from jmt_tpu_torch.models.i3d import InceptionModule
    from jmt_tpu_torch.ops.inception import fold_inception_weights
    from jmt_tpu_torch.ops.kernels.inception import inception_module_fused
    name, c, hw, spec, _ = inception_modules()[-1]
    gen = torch.Generator().manual_seed(0)
    m = InceptionModule(c, spec, dtype=torch.bfloat16, avg_tail=True)
    init_parameters(m, gen)
    random_bn(m, gen)
    fw = fold_inception_weights(m.cuda().eval()._folded_branch,
                                torch.bfloat16)
    x = torch.randn(128, 8, hw, hw, c, device="cuda").relu_().to(
        torch.bfloat16).permute(0, 4, 1, 2, 3)

    def call():
        return inception_module_fused(x, fw, spec, avg_tail=True)

    ops = launch_ms(call, reps=10)
    emit({"module": name, "clips": 128,
          "package": os.path.dirname(jmt_tpu_torch.__file__),
          "ms": time_ms(call, iters=20, warmup=3),
          "device_ms": sum(ms for _, ms in ops), "device_ops": ops})


def tree_times(tree: str, mode: str) -> list:
    """The records of ``--mel-times`` / ``--k4-times`` / ``--k3-times``
    run in a fresh process from ``tree``, on that tree's jmt_tpu_torch."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           f"--{mode}-times"], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"--{mode}-times in {tree} failed:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def tree_ab(trees, mode: str) -> None:
    """``--mel-ab`` / ``--k4-ab`` / ``--k3-ab TREE...``: a same-call A/B
    of K1, K4 or K3's Mixed_5c launch, each
    tree's own jmt_tpu_torch in turn (parent, change, change, parent), each
    in a fresh process (``tree_times``)."""
    for tree in trees:
        for rec in tree_times(tree, mode):
            emit({"phase": f"{mode}_ab", "tree": tree, **rec})


def determinism(forwards: int = 20, kernel_calls: int = 30) -> None:
    """``--determinism``: how far repeated runs on the same weights and
    inputs move. The flagship's eval forward (bf16, flag on, B = 8,
    S = 16) ``forwards`` times, each submodule's output caught by a hook
    (the log-mel, each backbone, each intra-modal fusion, the JMT, V/A),
    then each of its inception modules' K3 launches and its attention
    problems' K2 launches repeated ``kernel_calls`` times on their
    captured inputs: per output, how many runs differ from the first and
    the largest |delta|."""
    import jmt_tpu_torch  # noqa: F401  (fails outside the repository)
    from jmt_tpu_torch.models import i3d
    from jmt_tpu_torch.ops import attention
    from jmt_tpu_torch.ops.kernels import fused_attention as fa
    from jmt_tpu_torch.train.loops import preprocess
    model = make_model(FLAGSHIP_CONFIG, torch.bfloat16,
                       i3d_fused_inception=True).cuda().eval()
    x = {k: torch.from_numpy(v).cuda() for k, v in zip(
        ("clips", "audio", "wavlm"), request(np.random.default_rng(0), 8,
                                             16))}
    names = ("backbones.audio_resnet18", "backbones.vision_r2d1",
             "backbones.vision_i3d", "transformer_visio_modality_fusion",
             "transformer_audio_modality_fusion",
             "fusion_model.mm_transformer")
    caught, k3_inputs, k2_inputs = {}, [], []
    mods = dict(model.named_modules())
    for name in names:
        mods[name].register_forward_hook(
            lambda m, i, o, name=name: caught.__setitem__(
                name, o.float().cpu()))
    fused = i3d.inception_module_fused
    core = attention.fused_attention

    def k3(*args, **kw):
        k3_inputs.append((args, kw))
        return fused(*args, **kw)

    def k2(q, k, v):
        k2_inputs.append((q, k, v))
        return core(q, k, v)

    i3d.inception_module_fused, attention.fused_attention = k3, k2

    def forward() -> dict:
        caught.clear()
        k3_inputs.clear()
        k2_inputs.clear()
        with torch.inference_mode():
            spec, clips = preprocess(model, x)
            v, a = model(spec, clips, x["wavlm"])
        return dict(caught, spec=spec.float().cpu(), v=v.float().cpu(),
                    a=a.float().cpu())

    def tally(runs: list) -> dict:
        return {k: {"differ": sum(not torch.equal(r[k], runs[0][k])
                                  for r in runs[1:]),
                    "max_abs": max(float((r[k] - runs[0][k]).abs().max())
                                   for r in runs[1:])}
                for k in runs[0]}

    moved = []
    try:
        runs = [forward() for _ in range(forwards)]
        t = tally(runs)
        emit({"phase": "determinism", "what": "flagship eval forward",
              "runs": forwards, **t})
        moved += [k for k, r in t.items() if r["differ"]]
        with torch.inference_mode():
            for j, (args, kw) in enumerate(list(k3_inputs)):
                outs = [{"out": fused(*args, **kw).float().cpu()}
                        for _ in range(kernel_calls)]
                t = tally(outs)["out"]
                emit({"phase": "determinism", "what": f"K3 launch {j}",
                      "avg_tail": bool(kw.get("avg_tail")),
                      "runs": kernel_calls, **t})
                moved += [f"K3 launch {j}"] * bool(t["differ"])
            for j, (q, k, v) in enumerate(list(k2_inputs)):
                outs = [{"out": fa.fused_attention(q, k, v).float().cpu()}
                        for _ in range(kernel_calls)]
                t = tally(outs)["out"]
                emit({"phase": "determinism", "what": f"K2 launch {j}",
                      "shape": list(q.shape), "runs": kernel_calls, **t})
                moved += [f"K2 launch {j}"] * bool(t["differ"])
    finally:
        i3d.inception_module_fused, attention.fused_attention = fused, core
    if moved:
        raise AssertionError(f"not bitwise run to run: {moved}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    times = {"--mel-times": mel_times, "--k4-times": k4_times,
             "--k3-times": k3_times}
    if sys.argv[1:2] and sys.argv[1] in times:
        times[sys.argv[1]]()
        return 0
    if sys.argv[1:2] in (["--mel-ab"], ["--k4-ab"], ["--k3-ab"]):
        tree_ab(sys.argv[2:], sys.argv[1][2:-3])
        return 0
    if sys.argv[1:2] == ["--determinism"]:
        print(nvidia_smi())
        determinism()
        return 0
    import jmt_tpu_torch  # noqa: F401  (fails outside the repository)

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    with phase("build"):
        registers = phase_build()
    gen = torch.Generator().manual_seed(0)
    with phase("kernels"), full_fp32():
        kernels = [check_mel(gen, registers), check_attention(gen),
                   {"name": "inception_module_fused", "route": "cuda",
                    "source": "jmt_tpu_torch/csrc/inception.cu",
                    "replaces": "jmt_tpu/ops/inception_pallas.py:482",
                    "dtype": "bfloat16", **check_inception(gen)}]
        k3_pool_in = check_inception(gen, absorbed=True)
    rng = np.random.default_rng(0)
    with phase("flagship"):
        launches, model_on, reqs = phase_flagship(rng)
    with phase("flagship_flag_off"):
        phase_flag_off(model_on, reqs[8])
    with phase("flagship_absorbed"):
        absorbed = phase_absorbed(model_on, reqs)
    del model_on
    torch.cuda.empty_cache()
    with phase("slice"):
        phase_slice(rng)
    torch.cuda.empty_cache()
    with phase("pool1x1"):
        k4 = phase_pool1x1(registers)
    torch.cuda.empty_cache()
    with phase("card_vs_cpu"), full_fp32():
        phase_card_vs_cpu()
    torch.cuda.empty_cache()
    with phase("train"):
        trained = phase_train(np.random.default_rng(5))
    with phase("train_card_vs_cpu"), full_fp32():
        phase_train_card_vs_cpu()
    with phase("stitched_eval"):
        phase_stitched_eval(trained)
    del trained
    torch.cuda.empty_cache()
    with phase("cli_train"):
        exp = phase_cli_train()
    with phase("cli_resume"):
        phase_cli_resume(exp)
    with phase("cli_eval"):
        phase_cli_eval(exp)
    with phase("serve"):
        phase_serve(exp)
    with phase("cli_default_config"):
        phase_cli_default_config()
    with phase("cli_files_pretrained"):
        phase_cli_files_pretrained()
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    kernels[2]["pool_in"] = dict(
        k3_pool_in, launches=absorbed["inception_module_fused"],
        pool_in_launches=absorbed["inception_pool_in"],
        launches_of="one graphed forward of the flagship_absorbed server "
                    "(bucket 8's capture)")
    kernels[2]["registers"] = {
        "bf16 (igemm_sm90)": max((v for f, v in registers["inception"].items()
                                  if "igemm_sm90" in f), default=None),
        "f32 (inception_gemm)": max((v for f, v in
                                     registers["inception"].items()
                                     if "inception_gemm" in f), default=None)}
    kernels.append(k4)
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
