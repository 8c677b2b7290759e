"""Run logging: JSON-lines, free text and stdout.

Counterpart of ``jmt_tpu/core/logging.py``: ``log.json`` (one
``DLLL {...}`` record a call, the reference's DLLogger line format),
``log.txt`` and stdout mirroring, behind a module-level logger that
``init_logger`` replaces. Each record is flushed as it is written.
Under a process group rank 0 alone writes (the reference's master-pid
gating, generalized to ranks).
"""
from __future__ import annotations

import atexit
import datetime
import json
import os
import sys
from typing import IO, Any, Optional


class JsonLinesLogger:
    """Logs free text or structured records to json-lines/text/stdout."""

    JSON_PREFIX = "DLLL "

    def __init__(self, json_path: Optional[str] = None,
                 txt_path: Optional[str] = None, stdout: bool = True):
        self._json_f: Optional[IO] = open(json_path, "a") if json_path \
            else None
        self._txt_f: Optional[IO] = open(txt_path, "a") if txt_path else None
        self._stdout = stdout
        atexit.register(self.close)

    def log(self, data: Any, step: Any = None) -> None:
        now = datetime.datetime.now().isoformat()
        if isinstance(data, str):
            record = {"timestamp": now, "step": step, "msg": data}
            text = data
        else:
            record = {"timestamp": now, "step": step, "data": data}
            text = json.dumps(data, default=str)
        if self._json_f:
            self._json_f.write(self.JSON_PREFIX
                               + json.dumps(record, default=str) + "\n")
        if self._txt_f:
            self._txt_f.write(f"{now} {text}\n")
        self.flush()  # a killed run keeps its log
        if self._stdout:
            print(text, file=sys.stdout, flush=True)

    def metrics(self, step: Any, **metrics: Any) -> None:
        self.log(metrics, step=step)

    def flush(self) -> None:
        for f in (self._json_f, self._txt_f):
            if f and not f.closed:
                f.flush()

    def close(self) -> None:
        for f in (self._json_f, self._txt_f):
            if f and not f.closed:
                f.close()


_GLOBAL: Optional[JsonLinesLogger] = None


def init_logger(outdir: Optional[str] = None, stdout: bool = True
                ) -> JsonLinesLogger:
    """Replace the logger: log.json and log.txt under ``outdir`` (none
    when it is None), stdout when ``stdout``; off rank 0 a logger that
    writes nothing. Closes the one it replaces."""
    from jmt_tpu_torch.parallel.mesh import is_main_process
    global _GLOBAL
    if _GLOBAL is not None:
        _GLOBAL.close()
    if not is_main_process():
        _GLOBAL = JsonLinesLogger(stdout=False)
    elif outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        _GLOBAL = JsonLinesLogger(os.path.join(outdir, "log.json"),
                                  os.path.join(outdir, "log.txt"),
                                  stdout=stdout)
    else:
        _GLOBAL = JsonLinesLogger(stdout=stdout)
    return _GLOBAL


def get_logger() -> JsonLinesLogger:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = JsonLinesLogger(stdout=True)
    return _GLOBAL


def log(data: Any, step: Any = None) -> None:
    get_logger().log(data, step=step)
