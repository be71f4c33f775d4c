"""Time-series sink and profiling hook (``repro.obs.sink``, with the
profiler on ``torch.profiler``).

``JsonlSink`` appends the telemetry snapshot to a JSONL file every
``interval_s`` from a daemon thread: a run leaves behind a greppable time
series (one JSON object per line, wall-clock stamped) even when nobody
was curling /metrics.

``ProfileHook`` wraps ``torch.profiler`` (host and device activity)
around a chosen window of learner updates (``--profile-steps A:B``): the
trace starts before update A and stops after update B, both ends
included, and is written as one Chrome trace,
``<profile_dir>/updates_<A>_<B>.pt.trace.json`` (the JAX hook writes a
TensorBoard profile directory instead). Failures (profiler unavailable,
directory not writable) disable the hook with a one-line note instead of
killing training.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

# idle host seconds between the profiler's start and update A: the
# profiler now and then stamps the card's events milliseconds early and
# drops those that fall before its window (``tools/trace_clock.py``)
START_PAD_S = 0.05


class JsonlSink:
    """Periodic snapshot dumps: one JSON object per line."""

    def __init__(self, path: str,
                 snapshot_fn: Callable[[], Dict[str, Any]],
                 interval_s: float = 5.0):
        self.path = path
        self._snapshot_fn = snapshot_fn
        self._interval_s = max(0.05, interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.lines_written = 0

    def _write_one(self, f) -> None:
        try:
            snap = self._snapshot_fn()
        except Exception as e:
            snap = {"error": repr(e)}
        f.write(json.dumps({"t": time.time(), "telemetry": snap},
                           default=float))
        f.write("\n")
        f.flush()
        self.lines_written += 1

    def _run(self) -> None:
        with open(self.path, "a") as f:
            while not self._stop.wait(self._interval_s):
                self._write_one(f)
            self._write_one(f)      # final state on shutdown

    def start(self) -> "JsonlSink":
        self._thread = threading.Thread(target=self._run,
                                        name="telemetry-sink",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def parse_profile_steps(spec: str) -> Tuple[int, int]:
    """``"A:B"`` -> (A, B), inclusive update-index window, A <= B."""
    a, sep, b = spec.partition(":")
    if not sep:
        raise ValueError(f"--profile-steps wants A:B, got {spec!r}")
    lo, hi = int(a), int(b)
    if lo < 0 or hi < lo:
        raise ValueError(f"bad profile window {spec!r} (need 0<=A<=B)")
    return lo, hi


def _sync_current_stream() -> None:
    """Wait for the work queued on the calling thread's current CUDA
    stream (the learner's own, inside its loop); nothing on the CPU."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class ProfileHook:
    """Start/stop ``torch.profiler`` around updates [A, B].

    At the start the learner's stream is synchronised, the profiler
    started and ``START_PAD_S`` of idle host time let pass before update
    A; after update B the stream is synchronised again and the profiler
    stopped. ``path`` is the Chrome trace written at the stop."""

    def __init__(self, steps: str, out_dir: str):
        self.lo, self.hi = parse_profile_steps(steps)
        self.out_dir = out_dir
        self.path = os.path.join(out_dir,
                                 f"updates_{self.lo}_{self.hi}.pt.trace.json")
        self.active = False
        self.done = False
        self._prof = None

    def on_step(self, next_update: int) -> None:
        """Call once per loop iteration with the index of the update
        about to run (0-based ``learner.updates``), on the learner's
        thread and stream."""
        if self.done:
            return
        if not self.active and self.lo <= next_update <= self.hi:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                os.makedirs(self.out_dir, exist_ok=True)
                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                _sync_current_stream()
                self._prof = profile(activities=activities)
                self._prof.start()
                self.active = True
                time.sleep(START_PAD_S)
                print(f"[obs] torch.profiler tracing updates "
                      f"[{self.lo}, {self.hi}] -> {self.path}", flush=True)
            except Exception as e:
                print(f"[obs] profiling disabled: {e!r}", flush=True)
                self._prof = None
                self.done = True
        elif self.active and next_update > self.hi:
            self.stop()

    def stop(self) -> None:
        """Stop the profiler (if running) and write its trace; idempotent.
        """
        if self.active:
            self.active = False
            try:
                _sync_current_stream()
                self._prof.stop()
                self._prof.export_chrome_trace(self.path)
            except Exception as e:
                print(f"[obs] profiler stop failed: {e!r}", flush=True)
            self._prof = None
        self.done = True
