"""The flight recorder (``repro.obs``) for the port's distributed runtime.

Four pieces, all stdlib-only at import time (``ProfileHook`` imports
``torch.profiler`` when it starts):

  metrics   a registry of named counters / gauges / integer histograms
            plus pull-time *producers*. The queue, the transports, the
            inference service and the learner write their counters
            through it, and ``Learner.telemetry_snapshot`` /
            ``group.merge_telemetry`` read one ``collect()``: live
            metrics and end-of-run telemetry are one data source.
  trace     sampled per-trajectory lifecycle spans (env unroll -> serde
            encode -> transport -> queue wait -> batch collect -> train
            step -> publish), stamped across process and socket
            boundaries and normalized to the learner's clock, exported
            as Chrome trace-event JSON (Perfetto, chrome://tracing).
  http      a background stdlib HTTP server next to the learner serving
            ``/metrics`` (Prometheus text), ``/healthz`` (ok / degraded
            / unhealthy) and ``/telemetry`` (live JSON).
  sink      periodic JSONL dumps of the telemetry snapshot, and the
            ``--profile-steps A:B`` hook running ``torch.profiler`` over
            chosen learner updates.

``ObsConfig`` is the one knob bag the CLI builds and the runtime threads
through ``run_async_training(obs=...)`` / ``run_group_training(obs=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, IntHistogram, Registry)
from repro_torch.obs.trace import SPAN_NAMES, TraceRecorder  # noqa: F401


@dataclasses.dataclass
class ObsConfig:
    """What the operator asked to observe. All fields default to off;
    an all-defaults ObsConfig still enables phase timing (it only
    exists because someone passed ``obs=``)."""

    metrics_port: Optional[int] = None      # None = no HTTP server
    metrics_host: str = "127.0.0.1"
    trace_path: Optional[str] = None        # Chrome trace JSON out
    trace_every: int = 64                   # sample every Nth unroll/actor
    profile_steps: Optional[str] = None     # "A:B" learner-update window
    profile_dir: str = "/tmp/repro-profile"
    sink_path: Optional[str] = None         # JSONL time series out
    sink_interval_s: float = 5.0
    telemetry_interval_s: float = 2.0       # child->parent pipe shipping
    # set by the runtime once the HTTP server binds (port 0 resolves
    # here), so tests and log lines can discover the real address
    bound_address: Optional[Tuple[str, int]] = None
