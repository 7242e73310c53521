"""The port's tracing: spans on the profiler's clock and the training
step's phase account.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records, and otherwise one shared no-op context that makes no
call into the dispatcher. Spans nest. Their names:

- ``train_step/<phase>``: each phase of ``train/gan.py``'s step (``PHASES``);
- ``generator``: a generator forward (``train/gan.py::_forward``);
- ``discriminator``: a discriminator pass (``train/gan.py::discriminate``);
- ``aux_loss``: the mel / STFT losses (``train/gan.py::_aux_loss``);
- ``attention``: a Transformer layer's self-attention, its projections
  and the banded attention's kernels (``layers/transformer.py``);
- ``collective``: a collective of ``parallel/mesh.py``;
- ``recompute_grads:<plain>``: a hand kernel's recompute backward
  (``ops/_recompute.py``).

The phase account (``StepAccount``) is always on. At each boundary of a
step's phases it records one timing CUDA event on the current stream
(taken from a pool; on the CPU it reads the host clock instead) and the
host's ``time.time_ns()``, the clock the profiler dates its events by. It
never synchronises: a step's events are read once its last one has
completed (``query()``), at the next step or when ``steps()`` or
``records()`` is called, and go back to the pool. On the in-order stream
the phases tile the step, so a phase's device ms counts its device work and
the time the device waited for that phase's launches.

Each resolved step is a record keyed by ``state.steps`` as the step began:
per phase that ran, its device ms (boundary to boundary) and its host start
and end in ``time.time_ns()``. The last ``RING`` records are kept. A phase
that a step's gate turned off records nothing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Iterable

import torch

PHASES = ("generator_loss", "generator_backward", "generator_update",
          "regeneration", "discriminator_loss", "discriminator_backward",
          "discriminator_update")
RING = 4096  # resolved steps kept

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@dataclasses.dataclass(frozen=True)
class PhaseTime:
    """One phase of one step: its device ms and its host start and end
    (``time.time_ns()``)."""
    ms: float
    start_ns: int
    end_ns: int


# resolved (steps, {phase: PhaseTime}), oldest first; their count ever made
_records: collections.deque = collections.deque(maxlen=RING)
_resolved = 0
# accounts closed whose events the device has not all passed yet
_pending: collections.deque = collections.deque()
_pool: dict = collections.defaultdict(list)  # device index -> free events


def _event(device: torch.device) -> torch.cuda.Event:
    free = _pool[device.index]
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _resolve() -> None:
    """Read the closed accounts whose last mark has passed, in order."""
    global _resolved
    while _pending and _pending[0]._passed():
        account = _pending.popleft()
        marks = account._marks
        _records.append((account.steps, {
            name: PhaseTime(account._ms(a, b), start, end)
            for (name, start, end), a, b in zip(account._phases, marks,
                                                marks[1:])}))
        _resolved += 1
        if account._cuda:
            _pool[account._device.index].extend(marks)


class _Phase:
    def __init__(self, account: "StepAccount", name: str):
        self._account, self._name = account, name

    def __enter__(self):
        self._span = span(f"train_step/{self._name}")
        self._span.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        account = self._account
        account._marks.append(account._mark())
        account._phases.append((self._name, self._start, time.time_ns()))
        return self._span.__exit__(*exc)


class StepAccount:
    """``account = StepAccount(state.steps, device)``, then ``with
    account.phase(name):`` around each phase that runs, and
    ``account.close()`` once the step is done."""

    def __init__(self, steps: int, device: torch.device):
        _resolve()
        self.steps = steps
        self._device = device
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.current_stream(device)
        self._phases: list = []  # (name, host start, host end)
        # a CUDA event recorded at each boundary, else the host's clock
        self._marks = [self._mark()]

    def _mark(self):
        if not self._cuda:
            return time.time_ns()
        event = _event(self._device)
        event.record(self._stream)
        return event

    def _passed(self) -> bool:
        return not self._cuda or self._marks[-1].query()

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self._cuda else (b - a) / 1e6

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def close(self) -> None:
        _pending.append(self)
        _resolve()


def resolved() -> int:
    """How many steps have been resolved in this process so far (the
    ``since`` of a later ``records``)."""
    return _resolved


def records(since: int = 0) -> list[tuple[int, dict]]:
    """``(steps, {phase: PhaseTime})`` of the steps resolved after the
    first ``since`` (``resolved()`` read earlier), oldest first; those the
    ring has dropped are left out."""
    _resolve()
    kept = _resolved - len(_records)
    return list(_records)[max(since - kept, 0):]


def steps(lo: int | None = None, hi: int | None = None) -> dict:
    """``{steps: {phase: PhaseTime}}`` of the kept steps with ``lo <= steps
    < hi`` (either bound left open with None); a step run twice reads its
    latest record."""
    return {k: phases for k, phases in records()
            if (lo is None or k >= lo) and (hi is None or k < hi)}


def mean_ms(phases: Iterable[dict], names: Iterable[str]) -> float | None:
    """The mean over ``phases`` (each a step's ``{phase: PhaseTime}``) of
    the device ms of the phases ``names``, a phase that did not run counting
    0; None without a step."""
    phases, names = list(phases), tuple(names)
    if not phases:
        return None
    return sum(p[n].ms for p in phases for n in names if n in p) / len(
        phases)

