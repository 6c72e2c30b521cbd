"""Named host ranges around the layers of a step, read by `torch.profiler`.

`span(name)` is `torch.profiler.record_function(name)` while a profiler is
recording, so that its trace holds the range as a `user_annotation` and
every card operation launched inside it can be tied to it through its
launch; otherwise it is one shared null context, whose cost is a module
attribute read. Nothing is kept apart from the profiler's own record.

The training steps' spans: `ssl4gie.step` around one whole step, and
inside it `ssl4gie.augment` (the draws, their copies to the card, the
augmentation), `ssl4gie.forward` (the model and its loss),
`ssl4gie.backward` (the backward and the gradients' reduction) and
`ssl4gie.optimizer` (gradient norm, learning rate, the update, MoCo's
momentum encoder). A layer may appear more than once in a step.

`StepTrace` is the operator's trace: steps FIRST..LAST of an epoch under
the profiler, written as a chrome trace (`RuntimeConfig.profile_dir`).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
FIRST, LAST = 5, 10         # the steps of an epoch that `StepTrace` records


def span(name: str):
    """A profiler range named `name` while a profiler records, else the
    shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


class StepTrace:
    """Records steps FIRST..LAST of one epoch with `torch.profiler` (host
    activity, and the card's on a CUDA device) into `directory`, as
    `steps_<FIRST>-<LAST>.rank<r>.pt.trace.json`; with no directory it
    records nothing. Call `step(i)` before step i of the epoch; leaving the
    context ends a trace that the epoch cut short."""

    def __init__(self, directory: str | None, device, rank: int = 0):
        self.directory = directory
        self.device = torch.device(device)
        self.rank = rank
        self.prof = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self._stop()

    def step(self, i: int) -> None:
        if not self.directory:
            return
        if i == FIRST:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif i == LAST + 1 and self.prof is not None:
            self._stop()

    def _stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.directory,
            f"steps_{FIRST}-{LAST}.rank{self.rank}.pt.trace.json"))
        self.prof = None
