"""Process-level helpers: the primary process and the SIGTERM →
KeyboardInterrupt translation.

Counterpart of ``qfedx_tpu/utils/host.py``: ``is_primary`` (the process
that owns host-side IO: rank 0 of the process group, or the only
process), and ``install_sigterm_interrupt``/``restore_sigterm``, shared
by the streamed trainer and ``serve``: an orchestrator's TERM drains
exactly like a Ctrl-C.
"""

from __future__ import annotations

import signal
import threading


def is_primary() -> bool:
    """True on the process that owns host-side IO: rank 0 while a
    ``torch.distributed`` process group is up, else the only process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def install_sigterm_interrupt():
    """Translate SIGTERM into ``KeyboardInterrupt("SIGTERM")``.

    Returns an opaque token for ``restore_sigterm``; None when no
    handler was installed (not the main thread, or an embedding where
    ``signal.signal`` is rejected), and the caller then runs
    unguarded."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def _on_sigterm(signum, frame):
        raise KeyboardInterrupt("SIGTERM")

    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):  # signals unavailable; run unguarded
        return None
    return (prev,)


def restore_sigterm(token) -> None:
    """Undo ``install_sigterm_interrupt``. A previous handler installed
    outside Python reads back as None: restore SIG_DFL then, never leave
    the raising handler behind."""
    if token is None:
        return
    (prev,) = token
    try:
        signal.signal(
            signal.SIGTERM, prev if prev is not None else signal.SIG_DFL
        )
    except (ValueError, TypeError, OSError):
        pass
