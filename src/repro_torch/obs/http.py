"""Stdlib-only metrics endpoint next to the learner (the port's own copy of
``repro.obs.http``).

``MetricsServer`` runs a ``ThreadingHTTPServer`` on a daemon thread and
serves three routes off one ``snapshot_fn`` (the learner's
``telemetry_snapshot``, or the group parent's merged view):

  /metrics     the snapshot flattened to Prometheus text exposition
               format. Nested dicts become underscore-joined metric
               names; integer-keyed histograms become one sample per
               bucket (``repro_lag_hist{bucket="3"} 17``); the group's
               ``learners.learner_<k>.*`` subtrees become a
               ``learner="k"`` label, so one port exposes per-learner
               queue depth, fps, reconnects, torn tails for the fleet.
  /healthz     ok / degraded / unhealthy derived from the snapshot:
               unhealthy (HTTP 503) on lost-learner conditions (a
               spoke's hub connection gone, dead learners in the hub's
               view, a supervisor whose restart budget is exhausted);
               degraded (HTTP 200, status field says so) on
               loss/instability counters (drops, reconnects, torn
               tails, stale gradients, decode errors) and while a
               supervised restart or hub failover is in flight.
  /telemetry   the snapshot as JSON, verbatim.

The server must never take down the run it observes: snapshot or
rendering failures return HTTP 500 with the error text, and the
handler logs nothing to stderr.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_LEARNER_RE = re.compile(r"^learner_(\d+)$")

# degraded when any of these counters is nonzero anywhere in the tree
_DEGRADED_KEYS = ("dropped", "reconnects", "torn_tails", "stale_dropped",
                  "discarded", "decode_errors", "drain_errors",
                  "partial_rounds", "hub_gone_retries")


def _metric_name(path: List[str]) -> str:
    return "repro_" + _NAME_RE.sub("_", "_".join(path))


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _is_bucket_dict(d: Dict) -> bool:
    if not d:
        return False
    try:
        return all(int(k) == int(k) for k in d) and \
            all(isinstance(v, (int, float)) for v in d.values())
    except (TypeError, ValueError):
        return False


def render_prometheus(snap: Dict[str, Any]) -> str:
    """Flatten a telemetry snapshot into Prometheus text format.
    Strings, lists, and None are skipped (they are labels in spirit,
    not samples); ``learners.learner_<k>`` levels become a label."""
    lines: List[str] = []

    def walk(node: Any, path: List[str], labels: List[Tuple[str, str]]):
        if isinstance(node, dict):
            if _is_bucket_dict(node) and path:
                for k in sorted(node, key=lambda x: int(x)):
                    emit(path, labels + [("bucket", str(k))], node[k])
                return
            for k, v in node.items():
                k = str(k)
                m = _LEARNER_RE.match(k)
                if m and path and path[-1] == "learners":
                    walk(v, path[:-1], labels + [("learner", m.group(1))])
                else:
                    # dots inside a key are producer namespacing
                    # ("learner.lag_hist"), the same separator as
                    # nesting — split them so names come out uniform
                    walk(v, path + k.split("."), labels)
            return
        if isinstance(node, (bool, int, float)):
            emit(path, labels, node)
        # str / list / None: not a sample

    def emit(path: List[str], labels: List[Tuple[str, str]], v: Any):
        try:
            name = _metric_name(path)
            label_s = ""
            if labels:
                label_s = "{" + ",".join(
                    f'{k}="{val}"' for k, val in labels) + "}"
            lines.append(f"{name}{label_s} {_fmt(v)}")
        except (TypeError, ValueError, OverflowError):
            pass

    walk(snap, [], [])
    return "\n".join(lines) + "\n"


def health(snap: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
    """(http status, body) — unhealthy beats degraded beats ok."""
    bad: List[str] = []
    deg: List[str] = []

    def walk(node: Any, path: str):
        if not isinstance(node, dict):
            return
        for k, v in node.items():
            here = f"{path}.{k}" if path else str(k)
            if k == "hub_gone" and v:
                bad.append(here)
            elif k == "dead_learners" and v:
                bad.append(f"{here}={v}")
            elif k == "replicas_identical" and v is False:
                bad.append(here)
            elif k == "restarts_exhausted" and v:
                bad.append(f"{here}={v}")
            elif k in ("restart_in_flight", "failover_in_flight",
                       "degraded_solo") and v:
                deg.append(here)
            elif k in _DEGRADED_KEYS:
                n = v if isinstance(v, (int, float)) else len(v or ())
                if n:
                    deg.append(f"{here}={int(n)}")
            if isinstance(v, dict):
                walk(v, here)

    walk(snap, "")
    if bad:
        return 503, {"status": "unhealthy", "reasons": bad,
                     "degraded": deg}
    if deg:
        return 200, {"status": "degraded", "reasons": deg}
    return 200, {"status": "ok"}


class MetricsServer:
    """Background HTTP server over one zero-arg ``snapshot_fn``."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]], *,
                 host: str = "127.0.0.1", port: int = 0):
        self._snapshot_fn = snapshot_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # keep stderr clean
                pass

            def _send(self, code: int, body: str, ctype: str):
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                route = self.path.split("?", 1)[0]
                try:
                    if route == "/metrics":
                        snap = outer._snapshot_fn()
                        self._send(200, render_prometheus(snap),
                                   "text/plain; version=0.0.4")
                    elif route == "/healthz":
                        code, body = health(outer._snapshot_fn())
                        self._send(code, json.dumps(body),
                                   "application/json")
                    elif route == "/telemetry":
                        snap = outer._snapshot_fn()
                        self._send(200, json.dumps(snap, default=float),
                                   "application/json")
                    else:
                        self._send(404, "not found\n", "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as e:      # observing must not crash
                    try:
                        self._send(500, f"snapshot failed: {e!r}\n",
                                   "text/plain")
                    except OSError:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.address: Tuple[str, int] = \
            self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
