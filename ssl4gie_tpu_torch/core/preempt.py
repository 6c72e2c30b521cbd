"""Preemption detection and checkpoint-and-requeue (port of
`ssl4gie_tpu/core/preempt.py`).

The reference's elastic recovery is vendored submitit: SLURM signals the
job before preemption and submitit's `checkpoint()` hook resubmits the
same command (`Models/mae/submitit_pretrain.py:60-70`). Here:

1. `PreemptionGuard` latches SIGTERM / SIGUSR1 into a flag.
2. The Trainer polls the flag at step and epoch boundaries; when it is set
   it saves a resume checkpoint and raises `Preempted`.
3. The CLI turns `Preempted` into exit code `REQUEUE_EXIT_CODE` (42). The
   supervisor (SLURM requeue, a shell loop) relaunches the same command,
   and `Trainer.maybe_resume` picks the run up from the saved state.

Every process latches the signal; only the primary one writes.
"""

from __future__ import annotations

import signal
from typing import Iterable

REQUEUE_EXIT_CODE = 42

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class Preempted(Exception):
    """Raised by the training loop after the preemption checkpoint is
    written."""


class PreemptionGuard:
    """Latches termination signals into a poll-able flag. A context
    manager, so that the previous handlers are restored:

        with PreemptionGuard() as guard:
            ...
            if guard.should_stop:
                save(); raise Preempted()
    """

    def __init__(self, signals: Iterable[int] = _DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self._flag = False
        self._prev = {}

    def __enter__(self):
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):   # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        return False

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag

    def trigger(self):
        """Programmatic preemption (tests, external watchers)."""
        self._flag = True
