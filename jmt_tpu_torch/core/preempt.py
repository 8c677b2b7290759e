"""Graceful preemption: SIGTERM -> checkpoint at the next boundary.

Counterpart of ``jmt_tpu/core/preempt.py``. A signal sets a process-wide
flag; ``Runner.fit`` checks it every ``preempt_save_steps`` train steps
and at the epoch boundaries, saves the state and exits without
``passed.txt``, so re-launching the same command resumes. ``request()``
triggers the same path from code (tests, schedulers). Handlers are
installed from the main thread only (``signal.signal`` raises
elsewhere). Under a process group every rank acts on ``agreed()``, the
flag's maximum over the ranks, so that all ranks take the same branch
(a signal reaches the ranks at different times).
"""
from __future__ import annotations

import signal
import threading
from typing import List, Tuple

_EVENT = threading.Event()
_INSTALLED: List[Tuple[int, object]] = []


def install(signals=(signal.SIGTERM,)) -> bool:
    """Install the handlers. Idempotent; returns False (and installs
    nothing) off the main thread."""
    if _INSTALLED:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    for s in signals:
        _INSTALLED.append((s, signal.signal(s, _handler)))
    return True


def uninstall() -> None:
    """Restore the handlers that ``install`` replaced."""
    while _INSTALLED:
        s, prev = _INSTALLED.pop()
        signal.signal(s, prev)


def _handler(signum, frame) -> None:
    _EVENT.set()


def request() -> None:
    """Request preemption from code."""
    _EVENT.set()


def requested() -> bool:
    return _EVENT.is_set()


def agreed() -> bool:
    """Whether to act on the flag: its maximum over the ranks (a MAX
    all-reduce on the group's device, a collective that every rank calls
    at the same points), the flag itself in one process."""
    from jmt_tpu_torch.parallel import mesh
    if mesh.proc_info()[1] == 1:
        return _EVENT.is_set()
    return bool(mesh.all_agree([int(_EVENT.is_set())]).max())


def clear() -> None:
    _EVENT.clear()
