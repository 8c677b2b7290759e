"""Host-side WAV decode with the standard library's ``wave``.

Counterpart of ``jmt_tpu/data/audio_io.py``: PCM8/16/32 -> float32 in
[-1, 1], first channel; a missing or corrupt file gives None.
"""
from __future__ import annotations

import os
import wave
from typing import Optional

import numpy as np


def load_wav(path: str) -> Optional[np.ndarray]:
    """Returns float32 (L,) in [-1, 1], or None if missing/corrupt."""
    if not os.path.isfile(path):
        return None
    try:
        with wave.open(path, "rb") as w:
            n = w.getnframes()
            sw = w.getsampwidth()
            ch = w.getnchannels()
            raw = w.readframes(n)
    except (wave.Error, EOFError, OSError):
        return None
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        return None
    if ch > 1:
        data = data.reshape(-1, ch)[:, 0]
    return data


def write_wav(path: str, data: np.ndarray, sample_rate: int = 44100) -> None:
    """PCM16 writer (test fixtures / tooling)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
