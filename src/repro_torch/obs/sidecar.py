"""Sidecar health/metrics endpoint: a stdlib HTTP thread beside the service
(the port of ``src/repro/obs/sidecar.py``).

Liveness is normally driven by the trainer's batch fetches, but a
deployment wants shards to stay alive while the trainer is busy (or gone).
The sidecar closes that gap with no new dependency, one ``http.server``
daemon thread:

  * ``GET /metrics``  -- Prometheus text exposition of the process registry
    (``export.prometheus_text``), ready for a scraper.
  * ``GET /healthz``  -- JSON liveness summary: per-shard heartbeat ages
    from the attached ``HeartbeatBoard`` (when one is attached) plus the
    process status.
  * ``POST /healthz?shard=i`` (or JSON body ``{"shard": i}``; omit for all
    shards) -- an out-of-band heartbeat: feeds ``board.beat(shard)``, the
    SAME board the trainer's data-fetch acks feed, so the protocol's
    liveness collective sees sidecar beats and fetch acks identically and
    a shard whose pipeline stalls stays alive as long as something beats
    its ``/healthz``.  Without a board the beat is refused with 503, as
    the reference does; a bad shard argument is a 400.  On a rank of a
    process mesh the board holds that rank's shards (``first`` in the
    health summary); a beat for another rank's shard is refused with 409,
    the error naming the rank that holds it.

It binds 127.0.0.1 by default, and ``port=0`` picks a free port
(``Sidecar.port`` reports it), so tests and services on one host never
collide and nothing listens beyond loopback unless asked.  The server
thread is a daemon, so a crashed service never hangs on its sidecar.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.obs.export import prometheus_text
from repro_torch.obs.metrics import REGISTRY


class Sidecar:
  """Serve /metrics and /healthz for one process; see module docstring.

  Args:
    board: optional ``HeartbeatBoard`` -- attaches the out-of-band beat
      path (POST /healthz) and the per-shard age report (GET /healthz).
    registry: metrics registry to expose (default: the process registry).
    host / port: bind address; ``port=0`` picks a free port.
  """

  def __init__(self, board=None, registry=None, host: str = "127.0.0.1",
               port: int = 0):
    self._board = board
    self._registry = registry or REGISTRY
    sidecar = self

    class _Handler(BaseHTTPRequestHandler):
      def log_message(self, *a):  # no stderr chatter from the serving loop
        pass

      def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

      def do_GET(self):
        path = urlparse(self.path).path
        sidecar._count("GET", path)
        if path == "/metrics":
          self._reply(200, prometheus_text(sidecar._registry),
                      "text/plain; version=0.0.4")
        elif path == "/healthz":
          self._reply(200, json.dumps(sidecar._health()), "application/json")
        else:
          self._reply(404, "not found\n", "text/plain")

      def do_POST(self):
        url = urlparse(self.path)
        sidecar._count("POST", url.path)
        if url.path != "/healthz":
          self._reply(404, "not found\n", "text/plain")
          return
        if sidecar._board is None:
          self._reply(503, json.dumps({"error": "no heartbeat board"}),
                      "application/json")
          return
        try:
          shard = self._shard_arg(url)
        except (ValueError, json.JSONDecodeError) as e:
          self._reply(400, json.dumps({"error": str(e)}), "application/json")
          return
        try:
          sidecar._board.beat(shard, source="sidecar")
        except ValueError as e:  # a rank's board: another rank's shard
          self._reply(409, json.dumps({"error": str(e)}), "application/json")
          return
        self._reply(200, json.dumps({"ok": True, "shard": shard}),
                    "application/json")

      def _shard_arg(self, url):
        """Shard index from ?shard= or a JSON body; None = all shards."""
        q = parse_qs(url.query).get("shard")
        if q:
          return int(q[0])
        n = int(self.headers.get("Content-Length") or 0)
        if n:
          body = json.loads(self.rfile.read(n) or b"{}")
          if "shard" in body and body["shard"] is not None:
            return int(body["shard"])
        return None

    self._server = ThreadingHTTPServer((host, port), _Handler)
    self._server.daemon_threads = True
    self._thread = threading.Thread(target=self._server.serve_forever,
                                    daemon=True, name="repro-torch-obs-sidecar")
    self._thread.start()

  def _count(self, method: str, path: str) -> None:
    self._registry.counter(
        "repro_sidecar_requests_total",
        "HTTP requests served by the obs sidecar").inc(
            method=method, path=path)

  def _health(self) -> dict:
    out: dict = {"status": "ok"}
    if self._board is not None:
      ages = self._board.ages()
      out["shards"] = {
          "m": int(ages.shape[0]),
          # inf (a failed shard) is not JSON; report a sentinel string
          "ages_s": [float(a) if a != float("inf") else "inf" for a in ages],
      }
      if ages.shape[0] != self._board.m:  # a rank's board: its shards
        out["shards"]["first"] = self._board.first
    return out

  @property
  def port(self) -> int:
    return self._server.server_address[1]

  @property
  def url(self) -> str:
    host, port = self._server.server_address[:2]
    return f"http://{host}:{port}"

  def close(self) -> None:
    self._server.shutdown()
    self._server.server_close()
    self._thread.join(timeout=5)

  def __enter__(self) -> "Sidecar":
    return self

  def __exit__(self, *exc) -> None:
    self.close()
