"""Where kernel K4's time goes: build edited copies of a tree's K4 source,
each with one phase taken out, and time them on the card.

    python -m jmt_tpu_torch.tools.k4_phases TREE [VARIANT ...]

TREE is a checkout of the repo (``.`` or a ``git archive`` of another
commit unpacked under the ignored ``build/ab/``). Its ``csrc/`` is copied
to ``build/k4_phases/<tree>/<variant>/``, the variant's edits are applied
(each must match the source exactly, or the tool stops), and every copy is
compiled with the flags of ``ops/kernels/build.py``, one nvcc each, all
started together. Each library's ``jmt_pool3_1x1`` is then called through
ctypes on the TPU tool's six timed shapes (128 clips, bf16, N(0, 1) inputs
from a fixed seed): CUDA-events ms per call over back-to-back calls, and
ptxas's registers of the bf16 kernels. The edited kernels compute wrong
results by design; the unedited kernel is held to its plain version by
the tests and ``chip_smoke.py``.

Variants of the first design (the 28-load gather of
``csrc/implicit_gemm.cuh``):
``gather`` (the wmma products taken out: the 28-load gather, the staging
and the epilogue), ``unpooled`` (one load per A vector, not 28, then the
GEMM and epilogue) and ``epilogue`` (no K loop: the stores alone).
Variants of the Hopper design (``csrc/pool1x1_sm90.cuh``): ``no_mma`` (no
wgmma issued: staging, pool and epilogue), ``no_pool`` (the pool skipped:
staging, wgmma on stale A tiles, epilogue) and ``loads`` (staging only:
neither pool nor wgmma; the epilogue stores zeros); and, to weigh single
steps, ``no_fence`` (no proxy fence before the products), ``wait0``
(each chunk's products waited for at once, none left in flight) and
``one_k16`` (one of the four wgmma of a chunk), ``no_epilogue`` (no
stores of the output).
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from jmt_tpu_torch.ops.kernels import build

SHAPES = (((128, 8, 14, 14, 512), 64), ((128, 4, 7, 7, 832), 128),
          ((128, 8, 28, 28, 256), 64), ((128, 8, 14, 14, 480), 64),
          ((128, 8, 14, 14, 528), 128), ((128, 8, 28, 28, 192), 32))
OUT = Path(__file__).resolve().parents[2] / "build" / "k4_phases"

# (file, old text, new text) edits of each variant, by design
_FIRST = {
    "full": [],
    "gather": [("implicit_gemm.cuh",
                "wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);",
                "(void)fb;")],
    "unpooled": [("implicit_gemm.cuh",
                  "  uint4 r = ldg16(a + (size_t)ri.row * p.lda + k);\n",
                  "  uint4 r = ldg16(a + (size_t)ri.row * p.lda + k);\n"
                  "  if constexpr (V == kNegInf) return r;\n")],
    "epilogue": [("implicit_gemm.cuh", "  fetch(0);\n  stash(0);\n", ""),
                 ("implicit_gemm.cuh",
                  "const int nk = (p.k + BK - 1) / BK;", "const int nk = 0;")],
}
_SM90 = {
    "full": [],
    "no_mma": [("pool1x1_sm90.cuh", "  if (kMma) {", "  if (false) {")],
    "no_pool": [("pool1x1_sm90.cuh", "  if (kPool) {", "  if (false) {")],
    "loads": [("pool1x1_sm90.cuh", "  if (kMma) {", "  if (false) {"),
              ("pool1x1_sm90.cuh", "  if (kPool) {", "  if (false) {")],
    "no_fence": [("pool1x1_sm90.cuh",
                  "        fence_proxy_async();  // generic stores, read by "
                  "wgmma\n", "")],
    "wait0": [("pool1x1_sm90.cuh",
               "          asm volatile(\"wgmma.wait_group.sync.aligned 1;",
               "          asm volatile(\"wgmma.wait_group.sync.aligned 0;")],
    "one_k16": [("pool1x1_sm90.cuh", "for (int kk = 0; kk < 4; ++kk)",
                 "for (int kk = 0; kk < 1; ++kk)")],
    "no_epilogue": [("pool1x1_sm90.cuh",
                     "    if (active) epilogue<NW>(",
                     "    if (false) epilogue<NW>(")],
}


def variants_of(tree: Path) -> Dict[str, list]:
    """The variant table of the K4 design that ``tree`` holds."""
    csrc = tree / "jmt_tpu_torch" / "csrc"
    return _SM90 if (csrc / "pool1x1_sm90.cuh").exists() else _FIRST


def prepare(tree: Path, variant: str, edits: list) -> Path:
    """Copy tree's csrc for one variant and apply its edits."""
    dst = OUT / tree.resolve().name / variant
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(tree / "jmt_tpu_torch" / "csrc", dst)
    for name, old, new in edits:
        path = dst / name
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{variant}: edit of {name} matches "
                             f"{text.count(old)} times: {old!r}")
        path.write_text(text.replace(old, new))
    return dst


def bf16_registers(log: str) -> int:
    """The most registers ptxas gave a bf16 K4 kernel (the first design's
    ``inception_gemm<bf16, ...>``, the Hopper design's ``pool1x1_sm90``)."""
    regs, name = [0], ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split()[-1]
        elif "Used" in ln and "registers" in ln and (
                "pool1x1_sm90" in name or "nv_bfloat16" in name):
            regs.append(int(ln.split("Used")[1].split()[0]))
    return max(regs)


def compile_all(dirs: Dict[str, Path]) -> Dict[str, Tuple[Path, int]]:
    """One nvcc per variant, all at once; (library, registers) each."""
    procs = {}
    for variant, d in dirs.items():
        lib = d / "libpool1x1.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(d / "pool1x1.cu")]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT), lib)
    out = {}
    for variant, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {variant}:\n{log}")
        out[variant] = (lib, bf16_registers(log))
    return out


def time_lib(lib: Path, iters: int = 20) -> List[dict]:
    """ms per call of the library's bf16 K4 at each of SHAPES."""
    fn = ctypes.CDLL(str(lib)).jmt_pool3_1x1
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    recs = []
    for (n, t, h, w, c), co in SHAPES:
        x = torch.randn(n, t, h, w, c, device="cuda", generator=gen).to(
            torch.bfloat16)
        k = (0.05 * torch.randn(c, co, device="cuda", generator=gen)).to(
            torch.bfloat16)
        y = torch.empty(n, t, h, w, co, device="cuda", dtype=torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            status = fn(x.data_ptr(), k.data_ptr(), y.data_ptr(), n, t, h, w,
                        c, co, 1, stream)
            if status:
                raise RuntimeError(f"{lib}: CUDA error {status}")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        recs.append({"shape": [n, t, h, w, c], "co": co,
                     "ms": start.elapsed_time(end) / iters})
    return recs


def main(argv: Sequence[str] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k4_phases: needs a CUDA card", file=sys.stderr)
        return 1
    tree = Path(args[0])
    table = variants_of(tree)
    names = args[1:] or list(table)
    dirs = {v: prepare(tree, v, table[v]) for v in names}
    libs = compile_all(dirs)
    for v in names:
        lib, regs = libs[v]
        for rec in time_lib(lib):
            print(json.dumps({"tree": os.fspath(tree), "variant": v,
                              "registers": regs, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
