"""Process-level helpers: the SIGTERM → KeyboardInterrupt translation.

Counterpart of ``qfedx_tpu/utils/host.py``'s ``install_sigterm_interrupt``
and ``restore_sigterm``, shared by the streamed trainer and ``serve``: an
orchestrator's TERM drains exactly like a Ctrl-C. The reference's
``is_primary`` has no counterpart: the port runs in one process (ROADMAP
Queue 1 item 12).
"""

from __future__ import annotations

import signal
import threading


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
