"""POSIX signal handling for long solves.

Reference analogue: ``connect_signals`` / ``signals``
(`ADflow: src/utils/connect_signals.c:23-47`,
`src/utils/signals.F90:1,92`): SIGUSR1 = write the current solution and
continue, SIGUSR2 (and SIGTERM) = write and quit, polled once per nonlinear
iteration (`solvers.F90:1174-1222`) — the queue-limit survival kit.

Here the handlers only set flags (async-signal-safe); the solve loops
(solvers/steady.py, solvers/newton.py) poll ``check()`` between iterations
on the Python side and the ADFLOW object performs the actual write —
same split as the reference's C-handler + Fortran-poll design, without
MPI allreduce (single process controls the whole mesh; multi-host runs
inherit the launcher's signal fan-out).
"""

from __future__ import annotations

import signal
from typing import Callable, Optional


class SignalMonitor:
    """Installs SIGUSR1/SIGUSR2 handlers for the duration of a solve."""

    def __init__(self, on_write: Optional[Callable[[], None]] = None):
        self._write_requested = False
        self._quit_requested = False
        self._on_write = on_write
        self._prev = {}

    # -- handlers (flag-set only: async-signal-safe) -----------------------
    def _usr1(self, signum, frame):
        self._write_requested = True

    def _usr2(self, signum, frame):
        self._write_requested = True
        self._quit_requested = True

    def __enter__(self):
        for sig, h in ((signal.SIGUSR1, self._usr1),
                       (signal.SIGUSR2, self._usr2)):
            try:
                self._prev[sig] = signal.signal(sig, h)
            except (ValueError, OSError):   # non-main thread / platform
                self._prev.pop(sig, None)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        return False

    def check(self, get_state: Optional[Callable[[], object]] = None
              ) -> Optional[str]:
        """Poll between iterations: runs the write callback if requested;
        returns 'stop' when the solve should terminate, else None.

        ``get_state``: zero-arg provider returning the solver's CURRENT
        iterate (the solve loops keep it in a local, not on the ADFLOW
        object, so without this the write would checkpoint the stale
        pre-solve state).
        Only invoked when a write is actually pending."""
        if self._write_requested:
            self._write_requested = False
            if self._on_write is not None:
                try:
                    state = get_state() if get_state is not None else None
                    self._on_write(state)
                except Exception as e:    # never kill the solve on IO
                    print(f"  signal write failed: {e}")
        return "stop" if self._quit_requested else None
