"""Live HTTP observability endpoint for a serving engine — stdlib only.

Counterpart of ``repro/serve_mmo/httpd.py``.

``ObservabilityServer(engine, port=...)`` runs a ``ThreadingHTTPServer`` on
a daemon thread next to the engine's serving loop:

  /metrics   — Prometheus text exposition (serve_mmo/exposition.py):
               counters, per-bucket latency/host/device histograms, queue
               and executing gauges, estimator cells + drift, cache and
               flight-recorder counters.
  /healthz   — health JSON: 200 {"status": "ok", ...} while every circuit
               breaker is closed; 503 {"status": "degraded",
               "open_breakers": [...]} naming the open (bucket, backend,
               schedule) arms when any is open — a load balancer should
               drain a degraded instance while it still answers.  Also
               reports whether the serving loop thread is up.
  /snapshot  — the full ``engine.metrics_snapshot()`` JSON (rolling-window
               percentiles, admission state, estimator cells) — the same
               document ``--metrics-every`` tickers.
  /trace     — the flight recorder's Chrome trace-event JSON; save it and
               load in Perfetto / about://tracing.

Every handler reads a point-in-time snapshot the engine assembles under its
own locks and renders *outside* them, so a slow scraper (or a curl mid
load-test) can never stall the serving path.  Requests for anything else
get 404; handler errors get 500 with the exception name rather than killing
the handler thread.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.serve_mmo.exposition import render_prometheus

__all__ = ["ObservabilityServer", "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObservabilityServer:
  """HTTP front door for one engine's observability surface.

  ``port=0`` binds an ephemeral port (tests); read ``server.port`` after
  construction for the real one.  ``start()`` / ``stop()`` manage the
  serving thread; the server also works as a context manager."""

  def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0):
    self.engine = engine
    handler = _make_handler(engine)
    self._httpd = ThreadingHTTPServer((host, port), handler)
    self._httpd.daemon_threads = True
    self._thread: Optional[threading.Thread] = None

  @property
  def host(self) -> str:
    return self._httpd.server_address[0]

  @property
  def port(self) -> int:
    return self._httpd.server_address[1]

  @property
  def url(self) -> str:
    return f"http://{self.host}:{self.port}"

  def start(self) -> "ObservabilityServer":
    if self._thread is None:
      self._thread = threading.Thread(target=self._httpd.serve_forever,
                                      name="mmo-observability", daemon=True)
      self._thread.start()
    return self

  def stop(self) -> None:
    if self._thread is not None:
      self._httpd.shutdown()
      self._thread.join()
      self._thread = None
    self._httpd.server_close()

  def __enter__(self) -> "ObservabilityServer":
    return self.start()

  def __exit__(self, *exc) -> None:
    self.stop()


def _make_handler(engine):
  """Handler class closed over the engine (BaseHTTPRequestHandler is
  instantiated per request by the server, so state rides the closure)."""

  class Handler(BaseHTTPRequestHandler):
    server_version = "serve-mmo-observability/1.0"

    def log_message(self, fmt, *args):  # noqa: D102 — silence per-request logs
      pass

    def _send(self, status: int, content_type: str, body: str) -> None:
      payload = body.encode("utf-8")
      self.send_response(status)
      self.send_header("Content-Type", content_type)
      self.send_header("Content-Length", str(len(payload)))
      self.end_headers()
      self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
      path = self.path.split("?", 1)[0]
      try:
        if path == "/metrics":
          self._send(200, PROMETHEUS_CONTENT_TYPE,
                     render_prometheus(engine.observability_state()))
        elif path == "/healthz":
          loop = engine._thread
          resilience = getattr(engine, "resilience", None)
          open_breakers = ([] if resilience is None
                           else resilience.open_arms())
          degraded = bool(open_breakers)
          body = json.dumps({
              # degraded ≠ dead: open breakers mean some arm is failing and
              # its traffic rides a fallback — a load balancer should drain
              # this instance (503) while it still answers requests
              "status": "degraded" if degraded else "ok",
              "serving_loop_alive": bool(loop is not None and loop.is_alive()),
              "pending": engine.pending(),
              "open_breakers": [
                  {"bucket": c["bucket"], "backend": c["backend"],
                   "schedule": c["schedule"], "state": c["state"]}
                  for c in open_breakers],
          })
          self._send(503 if degraded else 200, "application/json", body)
        elif path == "/snapshot":
          self._send(200, "application/json",
                     json.dumps(engine.metrics_snapshot(), default=float))
        elif path == "/trace":
          self._send(200, "application/json",
                     json.dumps(engine.export_trace()))
        else:
          self._send(404, "text/plain; charset=utf-8",
                     "not found; try /metrics /healthz /snapshot /trace\n")
      except Exception as e:  # noqa: BLE001 — a handler bug must answer 500,
        # not silently kill this handler thread mid-scrape
        self._send(500, "text/plain; charset=utf-8",
                   f"internal error: {type(e).__name__}: {e}\n")

  return Handler
