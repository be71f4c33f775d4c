"""Observability (``repro.obs``): the metrics registry that the queue,
the actor pool and the learner write their counters into and that the
telemetry snapshot reads. The HTTP endpoint, the trace recorder and the
telemetry sink are not ported yet (ROADMAP.md, Queue 1 item 13)."""
