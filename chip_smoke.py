#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jmt_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # one card, no arguments

Phases, each printing one JSON record per line; any failure raises and the
script exits non-zero:

1. device and build: the card's name and power limit, nvcc build seconds;
2. kernels against their plain PyTorch versions on the card (TF32 off):
   the log-mel kernel at N=128 (f32, atol 5e-5) and the attention kernel
   at the serving path's four shapes in f32 (atol 2e-5) and bf16 (atol
   1e-2) plus head_dim 64, Lq != Lk and L = 128 shapes; times of kernel,
   plain version and library yardstick (CUDA events), and the bound;
3. the server: the slice configuration (R2D1 MAX + ResNet18 & wavLM with
   encoder_plus_self_attention, JMT SELF_ATTEN, 1 head, 1 layer) at full
   width with seeded random weights, bf16, buckets (1, 8), seq 16, 112 px;
   requests at batch 1, 3 and 8 with the launch counters read around them
   (1 log-mel and 10 attention launches per forward), then p50/p90 latency
   per bucket (and at bucket 8 with TF32 off), peak memory, and a
   torch.profiler breakdown of one forward per bucket: device kernel time
   by name and the device's idle share;
4. card against CPU: one seq-4 request, card f32 (kernels, TF32 off)
   against CPU f32 (plain versions), V/A max abs delta <= 1e-3; card bf16
   against card f32.

The last lines are the card's ``nvidia-smi`` name and power limit, the
kernels summary JSON, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository beside it, the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import contextlib
import json
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
# attention problems of one forward at bucket 8 (B=8, S=16, E=512, 1 head)
ATTN_PATH_SHAPES = (("intra_modal", 128, 2, 2, 512, 2),
                    ("jmt_encoders", 8, 16, 16, 512, 3),
                    ("jmt_cross_paired", 16, 16, 16, 512, 3),
                    ("self_atten_head", 128, 6, 6, 512, 2))
ATTN_EXTRA_SHAPES = (("head_dim_64", 64, 16, 16, 64),
                     ("lq_ne_lk", 4, 16, 128, 64),
                     ("l128_d512", 4, 128, 128, 512))


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


def phase_build():
    from jmt_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in
                    p.with_suffix(".log").read_text().splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, p in paths.items()}
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def check_mel(gen: torch.Generator) -> dict:
    from jmt_tpu_torch.ops import mel
    from jmt_tpu_torch.ops.kernels import melspec
    n = 128
    audio = (0.1 * torch.randn(n, mel.AUDIO_SAMPLES, generator=gen)).cuda()
    audio[-1] = 0.0  # a pad row of a bucket: must come out finite
    got = melspec.log_mel_spec(audio)
    want = mel.log_mel_batch(audio)
    err = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    if not finite or err > 5e-5:
        raise AssertionError(f"log-mel kernel: max abs err {err} (tol 5e-5),"
                             f" finite={finite}")

    window = torch.hann_window(mel.WIN_LENGTH, periodic=True, device="cuda")
    fb_t = torch.tensor(np.array(mel.mel_filterbank()), device="cuda").T

    def library():
        spec = torch.stft(audio, n_fft=mel.N_FFT, hop_length=mel.HOP_LENGTH,
                          win_length=mel.WIN_LENGTH, window=window,
                          center=True, pad_mode="reflect",
                          return_complex=True)
        db = 10.0 * torch.log10(torch.clamp(
            torch.matmul(fb_t, spec.abs() ** 2), min=mel.AMIN))
        db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
        return (db - mel.SPEC_MEAN) / mel.SPEC_STD

    lib_err = (library() - want).abs().max().item()
    n_frames = got.shape[-1]
    fft_flops = 5 * mel.N_FFT * np.log2(mel.N_FFT) * ((n_frames + 1) // 2)
    mel_flops = 2 * melspec.filterbank_nnz() * n_frames
    b_ms, b_by = bound(n * (mel.AUDIO_SAMPLES + mel.N_MELS * n_frames) * 4,
                       n * (fft_flops + mel_flops), F32_PEAK_FLOPS)
    rec = {"name": "log_mel", "route": "cuda",
           "source": "jmt_tpu_torch/csrc/melspec.cu",
           "replaces": "jmt_tpu/ops/pallas/melspec.py:75",
           "shape": [n, mel.AUDIO_SAMPLES], "dtype": "float32",
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "ms": time_ms(lambda: melspec.log_mel_spec(audio)),
           "plain_ms": time_ms(lambda: mel.log_mel_batch(audio)),
           "library_ms": time_ms(library),
           "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernel", **rec})
    return rec


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
            "bytes_ms": 0.0, "ops_ms": 0.0}
    shapes = list(ATTN_PATH_SHAPES) + [s + (0,) for s in ATTN_EXTRA_SHAPES]
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
            emit({"phase": "kernel", "kernel": "fused_attention", **rec})
            if dtype == torch.bfloat16 and per_fwd:
                for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    path[key] += per_fwd * rec[key]
                path["bytes_ms"] += per_fwd * n_bytes / HBM_BYTES_PER_S * 1e3
                path["ops_ms"] += per_fwd * flops / peak[dtype] * 1e3
    return {"name": "fused_attention", "route": "cuda",
            "source": "jmt_tpu_torch/csrc/fused_attention.cu",
            "replaces": "jmt_tpu/ops/pallas/fused_attention.py:66",
            "dtype": "bfloat16",
            "timing": "sum over the 10 launches of one bucket-8 forward",
            "max_abs_err": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16],
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "library_ms": path["library_ms"], "bound_ms": path["bound_ms"],
            "bound_by": ("bytes" if path["bytes_ms"] >= path["ops_ms"]
                         else "operations")}


def make_model(dtype, seed: int = 0):
    from jmt_tpu_torch.models.common import init_parameters
    from jmt_tpu_torch.models.jmt_model import JMTModel
    model = JMTModel(**SLICE_CONFIG, dtype=dtype)
    return init_parameters(model, torch.Generator().manual_seed(seed))


def request(rng, b: int, seq: int, img: int = 112):
    clips = rng.integers(0, 256, (b, seq, 8, img, img, 3), dtype=np.uint8)
    audio = (0.1 * rng.normal(size=(b, seq, 45599))).astype(np.float32)
    wavlm = rng.normal(size=(b, seq, 768)).astype(np.float32)
    return clips, audio, wavlm


def phase_server() -> dict:
    from jmt_tpu_torch.ops.kernels.fused_attention import fused_attention
    from jmt_tpu_torch.ops.kernels.melspec import log_mel_spec
    from jmt_tpu_torch.serve import InferenceServer
    rng = np.random.default_rng(0)
    server = InferenceServer(make_model(torch.bfloat16), seq=16,
                             buckets=(1, 8))
    reqs = {b: request(rng, b, 16) for b in (1, 3, 8)}
    server.predict(*reqs[1])  # first call: cuDNN autotune, library load
    torch.cuda.synchronize()

    log_mel_spec.launches = 0
    fused_attention.launches = 0
    outs = {b: server.predict(*reqs[b]) for b in (1, 3, 8)}
    torch.cuda.synchronize()
    launches = {"log_mel": log_mel_spec.launches,
                "fused_attention": fused_attention.launches}
    emit({"phase": "server_launches", "forwards": 3, **launches})
    if launches != {"log_mel": 3, "fused_attention": 30}:
        raise AssertionError(f"expected 3 log-mel and 30 attention launches "
                             f"for 3 forwards, got {launches}")
    for b, (v, a) in outs.items():
        for name, x in (("v", v), ("a", a)):
            if x.shape != (b, 16) or not np.isfinite(x).all() \
                    or float(np.std(x)) == 0.0:
                raise AssertionError(f"batch {b} {name}: shape {x.shape}, "
                                     f"finite={np.isfinite(x).all()}, "
                                     f"std={np.std(x)}")
        emit({"phase": "server_output", "batch": b,
              "v_std": float(np.std(v)), "a_std": float(np.std(a)),
              "v_mean": float(np.mean(v)), "a_mean": float(np.mean(a))})

    # bf16 serving under PyTorch's default flags. cuDNN runs some R(2+1)D
    # convs whose channel counts are not multiples of 8 (45, 230, 460, 921)
    # on an f32 engine after converting from bf16; the bucket-8 request is
    # timed with TF32 off as well, to show whether TF32 touches that engine.
    torch.cuda.reset_peak_memory_stats()
    flags = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    for b in (1, 8):
        emit({"phase": "server_latency", **request_latency(server, reqs[b]),
              **flags})
    emit({"phase": "server_memory",
          "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    with full_fp32():
        emit({"phase": "server_latency_tf32_off",
              **request_latency(server, reqs[8])})
    profile_forward(server, reqs[1])
    profile_forward(server, reqs[8])
    return launches


def request_latency(server, req, iters: int = 12, warmup: int = 2) -> dict:
    """p50/p90 of ``predict`` on the host clock (it returns numpy, so each
    call ends synchronized), and clips/s at the p50."""
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        server.predict(*req)
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    b, seq = req[0].shape[:2]
    p50 = times[len(times) // 2]
    return {"bucket": int(b), "p50_ms": p50,
            "p90_ms": times[int(len(times) * 0.9)],
            "clips_per_s": b * seq / (p50 / 1e3)}


def profile_forward(server, req, reps: int = 3) -> None:
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
    emit({"phase": "profile", "batch": int(req[0].shape[0]),
          "wall_ms_per_forward": wall_ms, "device_ms_per_forward": busy,
          "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
          "kernels_per_forward": sum(r[2] for r in rows),
          "top": [{"ms": r[0], "name": r[1], "calls": r[2]}
                  for r in rows[:25]]})


def phase_card_vs_cpu() -> None:
    from jmt_tpu_torch.serve import InferenceServer
    rng = np.random.default_rng(1)
    req = request(rng, 1, 4)
    bf16 = make_model(torch.bfloat16)
    sd = bf16.state_dict()
    f32_card, f32_cpu = make_model(None), make_model(None)
    f32_card.load_state_dict(sd)
    f32_cpu.load_state_dict(sd)
    out = {}
    for name, model, dev in (("card_bf16", bf16, None),
                             ("card_f32", f32_card, None),
                             ("cpu_f32", f32_cpu, "cpu")):
        server = InferenceServer(model, seq=4, buckets=(1,), device=dev)
        out[name] = server.predict(*req)
    d_cpu = max(float(np.abs(out["card_f32"][i] - out["cpu_f32"][i]).max())
                for i in range(2))
    d_bf16 = max(float(np.abs(out["card_bf16"][i] - out["card_f32"][i]).max())
                 for i in range(2))
    emit({"phase": "card_vs_cpu", "card_f32_vs_cpu_f32_max_abs": d_cpu,
          "card_bf16_vs_card_f32_max_abs": d_bf16,
          "va_std_cpu": float(np.std(out["cpu_f32"][0]))})
    if not d_cpu <= 1e-3:
        raise AssertionError(f"card f32 vs CPU f32 V/A delta {d_cpu} > 1e-3")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import jmt_tpu_torch  # noqa: F401  (fails outside the repository)

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    phase_build()
    gen = torch.Generator().manual_seed(0)
    with full_fp32():
        kernels = [check_mel(gen), check_attention(gen)]
    launches = phase_server()
    with full_fp32():
        phase_card_vs_cpu()
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
