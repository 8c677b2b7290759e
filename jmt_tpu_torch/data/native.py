"""ctypes binding of the native data-IO library (``native/jmt_dataio.cc``).

Counterpart of ``jmt_tpu/data/native.py``: a batched libjpeg decode on a
pthread pool and a RIFF/WAV decoder, behind a plain C interface, with
which ``data/datasets.WindowedDataset`` (``use_native``) reads an
Affwild2 tree's frames and wavs without Pillow or a Python decode per
file.

The library is built at first use from the repository's
``native/jmt_dataio.cc`` with the host's ``g++`` and the flags of
``native/Makefile`` into ``build/jmt_tpu_torch/native/``, named by a hash
of the source, the compiler and the flags, so an edited source is rebuilt
and an unchanged one reused. Nothing is written into ``native/``: the
committed ``native/libjmtdataio.so`` was built with ``-march=native`` on
another host and is never loaded, and ``make -C native`` is never run.

The WAV functions use that library. Where it does not build (a host
without libjpeg's headers, as the card machine is), they use a second
build of the same source with its JPEG half cut out, which needs no
libjpeg: such a host still decodes wavs natively, and only
``decode_jpeg_batch`` raises there.

A failed build raises with the compiler's output, and a second call in
the same process raises the same error without compiling again. (JAX's
binding falls back silently to its Python loaders: ``ROADMAP.md`` §C.4.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "jmt_dataio.cc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build" / "jmt_tpu_torch"
             / "native")
# native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-march=native")
LDLIBS = ("-ljpeg", "-lpthread")
CXX = "g++"

_libs: Dict[bool, ctypes.CDLL] = {}
_failed: Dict[bool, BaseException] = {}  # a build or load that failed
_lock = threading.Lock()


def _wav_half(text: str) -> str:
    """The source without its JPEG half (the section from the ``JPEG
    decode`` banner to the ``WAV decode`` banner, and libjpeg's header)."""
    def banner(title):
        return text.rindex("// ----", 0, text.index(f"// {title}"))

    text = text[:banner("JPEG decode")] + text[banner("WAV decode"):]
    return text.replace("#include <jpeglib.h>\n", "")


def library_path(jpeg: bool = True) -> Path:
    """The library of the whole source (``jpeg``), or of its WAV half.
    The host's name is hashed too: ``-march=native`` and the shared
    libraries it links tie a build to the host that made it, and a build
    directory may be copied to another."""
    libs = LDLIBS if jpeg else ("-lpthread",)
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (CXX, str(jpeg), platform.node(), platform.machine()) + CXXFLAGS
        + libs).encode()).hexdigest()
    name = "libjmtdataio" if jpeg else "libjmtdataio_wav"
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(jpeg: bool = True) -> Path:
    """Compile the library (the whole source, or with ``jpeg=False`` its
    WAV half) if it is not built yet; returns its path. Raises
    ``RuntimeError`` with the compiler's output when it fails."""
    out = library_path(jpeg)
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"the native decoder needs {CXX}, which is not "
                           f"on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = str(SOURCE)
    if not jpeg:  # a file of its own: builds may run side by side
        fd, source = tempfile.mkstemp(suffix=".cc", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(_wav_half(SOURCE.read_text()))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    libs = LDLIBS if jpeg else ("-lpthread",)
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, source, *libs],
                              capture_output=True, text=True)
    finally:
        if not jpeg:
            os.unlink(source)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)  # a failed link removes it
        raise RuntimeError(f"{CXX} failed on {SOURCE}"
                           f"{'' if jpeg else ' (its WAV half)'}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    return out


def load(jpeg: bool = True) -> ctypes.CDLL:
    """The ctypes handle of the library (``build``), built on first use.
    A failure is remembered: later calls raise it again."""
    with _lock:
        if jpeg in _failed:
            raise _failed[jpeg]
        lib = _libs.get(jpeg)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(build(jpeg)))
            except (RuntimeError, OSError) as e:
                _failed[jpeg] = e
                raise
            if jpeg:
                lib.jmt_decode_jpeg_batch.restype = ctypes.c_int
                lib.jmt_decode_jpeg_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.jmt_decode_wav_batch.restype = ctypes.c_int
            lib.jmt_decode_wav_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.jmt_decode_wav.restype = ctypes.c_int
            lib.jmt_decode_wav.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            _libs[jpeg] = lib
    return lib


def wav_library() -> ctypes.CDLL:
    """The whole library where it builds, else its WAV half (which
    raises if that fails too)."""
    try:
        return load()
    except (RuntimeError, OSError):
        return load(jpeg=False)


def available(jpeg: bool = True) -> bool:
    """Whether the whole library (JPEG and WAV), or with ``jpeg`` False
    at least its WAV functions, build and load here."""
    try:
        load() if jpeg else wav_library()
    except (RuntimeError, OSError):
        return False
    return True


def _c_paths(paths: List[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def decode_jpeg_batch(paths: List[str], h: int, w: int,
                      threads: int = 4) -> np.ndarray:
    """(n, h, w, 3) uint8 RGB, each image cropped at its top left or zero
    padded to (h, w); a missing or corrupt file is zeros (the reference's
    black frame)."""
    n = len(paths)
    out = np.zeros((n, h, w, 3), np.uint8)
    status = (ctypes.c_int * n)()
    load().jmt_decode_jpeg_batch(
        _c_paths(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, threads,
        status)
    return out


def decode_wav_batch(paths: List[str], out_len: int) -> np.ndarray:
    """(n, out_len) float32, each wav left-zero-padded (a longer one keeps
    its tail); a missing or corrupt wav is zeros."""
    n = len(paths)
    out = np.zeros((n, out_len), np.float32)
    wav_library().jmt_decode_wav_batch(
        _c_paths(paths), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_len)
    return out


def decode_wav(path: str, out_len: int) -> Optional[np.ndarray]:
    """One wav as ``decode_wav_batch`` decodes it, or None if it cannot
    be read."""
    out = np.zeros(out_len, np.float32)
    rc = wav_library().jmt_decode_wav(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_len)
    return out if rc == 0 else None
