"""Graceful-preemption guard: SIGTERM/SIGINT -> stop at the next safe point.

Copy of ``summer_clip_tpu/engine/preemption.py`` (it imports no JAX; the port
keeps its own copy). Cluster schedulers surface maintenance events and
autoscaler evictions as SIGTERM with a grace window; slurm (the scheduler the reference's ``scripts/*.sh``
headers target, e.g. ``summer_clip/scripts/train_gpt.sh``) likewise sends
SIGTERM before SIGKILL. The reference's answer is "re-run from the last
epoch checkpoint"; here the trainer reacts inside the grace window instead:

- ``BaseTrainer.train_loop`` installs a :class:`PreemptionGuard` — the
  FIRST signal only sets a flag, checked between steps/epochs, so the step
  in flight completes and the device stream stays consistent;
- epoch trainers stop after the epoch in flight, whose checkpoint they
  have just written;
- a SECOND signal restores default handling — a wedged job (e.g. a hung
  backend) can still be killed by the scheduler's follow-up.

The guard is also a context manager and restores previous handlers on exit,
so nested/short-lived uses (tests, one-shot evaluators) are safe.
"""

from __future__ import annotations

import logging
import signal
import threading
import typing as tp

__all__ = ["PreemptionGuard"]

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Latches termination signals into a poll-able "stop soon" flag."""

    def __init__(self, signals: tp.Sequence[int] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: tp.Dict[int, tp.Any] = {}
        self._installed = False

    # -- signal plumbing ----------------------------------------------------

    def install(self) -> "PreemptionGuard":
        """Route the guard's signals here. Main-thread only (CPython rule);
        called from a non-main thread this is a loud error, not a silent
        no-op — the trainer would otherwise believe it is preemption-safe."""
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def restore(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            # getsignal returns None for handlers installed by non-Python
            # code — those can't be re-installed from Python; SIG_DFL is the
            # only safe stand-in (passing None raises TypeError)
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._previous.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        self.trigger(signum)
        # second signal escalates: hand back the previous (or default)
        # handler so the scheduler's follow-up actually kills a job stuck
        # past the flag
        prev = self._previous.get(signum)
        signal.signal(signum, prev if prev is not None else signal.SIG_DFL)

    # -- trainer API ----------------------------------------------------------

    def trigger(self, signum: tp.Optional[int] = None) -> None:
        """Latch the stop flag (signal handler body; callable from tests)."""
        if not self._event.is_set():
            logger.warning("preemption signal %s: finishing the current step, "
                           "then checkpointing and stopping", signum)
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.restore()
