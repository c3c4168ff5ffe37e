"""Live Prometheus scrape endpoint over a :class:`~.registry.MetricRegistry`
(a copy of ``neuronx_distributed_tpu/obs/metrics_server.py``, stdlib only).

A stdlib ``http.server`` thread exposing

- ``GET /metrics``  — the Prometheus text exposition (re-rendered per
  scrape, so gauges/counters are always current); ``?scope=NAME`` selects
  an alternate renderer from ``scopes`` (the fleet's ``scope=fleet``
  renderer arrives with the fleet);
- ``GET /healthz``  — a JSON READINESS document: the caller-supplied
  liveness probe (e.g. engine steps / active slots) merged with the
  attached health ``monitor``'s rule state (``monitor=``: a
  :class:`~.health.HealthMonitor` or :class:`~.aggregate.FleetHealth`, or
  any object with ``healthz()``); a falsy ``"ok"`` — liveness gone OR a ``page``-severity
  alert firing — answers 503.

The server thread only reads the registry (under its lock) and the probe:
it never touches CUDA, so it cannot trip a ``forbid`` section's
process-global sync guard.  No third-party dependencies — the whole
server is stdlib.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, Optional
from urllib.parse import parse_qs

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background-thread HTTP server for ``/metrics`` + ``/healthz``.

    ``registry`` supplies the metrics text (or pass ``text_fn`` for a
    custom renderer, e.g. :func:`prometheus_from_scalars` over a finished
    run's records).  ``scopes`` maps
    ``?scope=NAME`` to alternate renderers (unknown scopes answer 400).
    ``health_fn`` returns the liveness dict; ``monitor`` (an object with
    ``healthz()`` — a health monitor or fleet health) folds rule state
    into the same document, and the response is 503 unless BOTH agree ok.
    ``autopilot`` (an object with ``healthz_fields()``, the fleet
    autopilot's surface) nests its controller
    state under ``"autopilot"`` (mode, last action, actions-in-window vs
    budget) — observability only, it never flips readiness: a paused or
    budget-exhausted autopilot is an operator concern, not a reason to
    pull the fleet out of the load balancer.  ``port=0`` binds an
    ephemeral port (read :attr:`port` after construction — the test
    harness pattern)."""

    def __init__(self, registry=None, *,
                 text_fn: Optional[Callable[[], str]] = None,
                 health_fn: Optional[Callable[[], dict]] = None,
                 monitor=None,
                 autopilot=None,
                 scopes: Optional[Dict[str, Callable[[], str]]] = None,
                 port: int = 0, host: str = "0.0.0.0"):
        if registry is None and text_fn is None:
            raise ValueError("MetricsServer needs a registry or a text_fn")
        self._text_fn = (text_fn if text_fn is not None
                         else registry.prometheus_text)
        self._scopes = dict(scopes) if scopes else {}
        self._monitor = monitor
        self._autopilot = autopilot
        self._health_fn = health_fn if health_fn is not None else (
            lambda: {"ok": True})
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler name)
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    params = parse_qs(query)
                    scope = params.get("scope", [None])[0]
                    if scope is None:
                        fn = outer._text_fn
                    else:
                        fn = outer._scopes.get(scope)
                        if fn is None:
                            self._reply(
                                400, "text/plain",
                                f"unknown scope {scope!r} (known: "
                                f"{sorted(outer._scopes)})\n".encode())
                            return
                    try:
                        body = fn().encode()
                    except Exception as e:  # a broken renderer is a 500
                        self._reply(500, "text/plain",
                                    f"metrics error: {e}\n".encode())
                        return
                    self._reply(200, PROM_CONTENT_TYPE, body)
                elif path == "/healthz":
                    try:
                        doc = outer._health_fn()
                        if outer._monitor is not None:
                            # readiness = liveness AND rule state: a
                            # page-severity alert takes the target out of
                            # the load balancer even while it still steps
                            hz = outer._monitor.healthz()
                            doc = {**doc, **hz,
                                   "ok": bool(doc.get("ok", True))
                                   and bool(hz.get("ok", True))}
                        if outer._autopilot is not None:
                            doc["autopilot"] = \
                                outer._autopilot.healthz_fields()
                    except Exception as e:
                        doc = {"ok": False, "error": str(e)}
                    code = 200 if doc.get("ok") else 503
                    self._reply(code, "application/json",
                                (json.dumps(doc) + "\n").encode())
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrape spam off the console
                logger.debug("metrics_server: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)
        self._thread.start()
        logger.info("metrics_server: serving /metrics and /healthz on "
                    "port %d", self.port)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def prometheus_from_scalars(records: Iterable[dict],
                            kinds: Optional[Dict[str, str]] = None) -> str:
    """Reconstruct a Prometheus text exposition from ``scalars.jsonl``-schema
    records (latest step wins per tag) — the offline half of the scrape
    story: a finished (or still appending) run's artifacts re-exposed
    without the producing process.

    ``kinds`` maps metric name -> "counter"|"gauge"|"histogram" (defaults
    to :data:`~.schemas.REGISTRY_METRICS`); undeclared scalar tags render
    as gauges, and histogram-flattened ``/le_*`` + ``/count``/``/sum``
    tags are reassembled into ``_bucket``/``_count``/``_sum`` lines."""
    from neuronx_distributed_tpu_torch.obs.registry import (
        _prom_name,
        _prom_val,
        read_histograms,
    )
    from neuronx_distributed_tpu_torch.obs.schemas import REGISTRY_METRICS

    kinds = REGISTRY_METRICS if kinds is None else kinds
    hists = read_histograms(records if isinstance(records, list)
                            else list(records))
    records = records if isinstance(records, list) else list(records)
    latest: Dict[str, tuple] = {}
    skip_suffixes = tuple(f"{h}/{s}" for h in hists for s in ("count", "sum"))
    for r in records:
        tag = r.get("tag")
        if tag is None or "/le_" in tag or tag in skip_suffixes:
            continue
        step = int(r.get("step", 0))
        prev = latest.get(tag)
        if prev is None or step >= prev[0]:
            latest[tag] = (step, float(r["value"]))

    lines = []
    for tag in sorted(latest):
        # undeclared tags fall back on the repo-wide naming convention:
        # `*_total` is a counter, everything else a gauge
        kind = kinds.get(tag) or ("counter" if tag.endswith("_total")
                                  else "gauge")
        if kind == "histogram":
            continue  # reassembled below from the flattened tags
        pname = _prom_name(tag)
        lines.append(f"# TYPE {pname} {kind}")
        lines.append(f"{pname} {_prom_val(latest[tag][1])}")
    for name in sorted(hists):
        h = hists[name]
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for le, cum in sorted(
                h["buckets"].items(),
                key=lambda kv: (math.inf if kv[0] == "inf"
                                else float(kv[0]))):
            edge = "+Inf" if le == "inf" else le
            lines.append(f'{pname}_bucket{{le="{edge}"}} {_prom_val(cum)}')
        lines.append(f"{pname}_sum {_prom_val(h['sum'])}")
        lines.append(f"{pname}_count {_prom_val(h['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")
