"""Periodic background-work handler ABC (port of
``visual_slam_tpu.handlers.base_handler``).

A stoppable thread with a wakeup event and ``trigger()``: the SLAM facade
pokes the handler at each keyframe insertion. Without ``threaded`` the
handler runs ``step()`` inline from ``trigger()`` and a failing step raises
to the caller (the JAX package logs it and goes on); the thread logs a
failing step, counts it in ``failures`` and keeps running.
"""
from __future__ import annotations

import abc
import logging
import threading


class BaseHandler(abc.ABC):
    def __init__(self, run_timeout: float = 0.1, threaded: bool = False, logger: logging.Logger | None = None):
        self.run_timeout = run_timeout
        self.threaded = threaded
        self.logger = logger or logging.getLogger(self.__class__.__name__)
        self._stop_flag = threading.Event()
        self._wakeup = threading.Event()
        self._thread: threading.Thread | None = None
        self.failures = 0

    def start(self) -> None:
        if self.threaded and self._thread is None:
            self._stop_flag.clear()
            # The thread launches its device work on the default stream, as
            # the tracking thread does: the card serialises them, the map
            # lock keeps their host state consistent.
            self._thread = threading.Thread(target=self.run, daemon=True, name=self.__class__.__name__)
            self._thread.start()

    def stop(self) -> None:
        self._stop_flag.set()
        self._wakeup.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def trigger(self) -> None:
        """Request one unit of work. Inline when not threaded."""
        if self.threaded:
            self._wakeup.set()
        else:
            self.step()

    def run(self) -> None:
        while not self._stop_flag.is_set():
            self._wakeup.wait(timeout=self.run_timeout)
            self._wakeup.clear()
            if self._stop_flag.is_set():
                break
            try:
                self.step()
            except Exception:  # pragma: no cover
                self.failures += 1
                self.logger.exception("handler step failed")

    @abc.abstractmethod
    def step(self) -> None:
        """One unit of background work."""
