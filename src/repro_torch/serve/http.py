"""Stdlib HTTP/SSE transport for the query frontend (port of
``repro.serve.http``; no dependencies).

Endpoints (JSON in, JSON out; every query answer is produced by the exact
same ``StreamingNGramService`` code path a direct caller would hit, so HTTP
responses are bit-identical to in-process calls):

  POST /v1/lookup    {"gram": [ids]} or {"grams": [[ids]...], "lengths": [...]}
                     -> {"count": n} / {"counts": [...]}
  POST /v1/topk      {"prefix": [ids], "k": 8}
                     -> {"n_distinct", "total", "terms", "counts"}
  POST /v1/complete  {"prefix": [ids], "steps": 16, "k": 8}  (SSE)
                     -> data: {"step", "term", "count"} events, then [DONE];
                     greedy continuation over a sliding (sigma-1)-token window
  GET  /v1/system/topology   shard/segment discovery + frontend state
  GET  /healthz              {"status": "ok"}

Admission verdicts map onto status codes: shed -> 503 (+ Retry-After),
tenant quota -> 429.  Priority class and tenant ride the ``X-Priority`` /
``X-Tenant`` headers.  The server is a ``ThreadingHTTPServer``: each
connection blocks on its ticket future while the continuous batcher coalesces
all live requests into shared device batches.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["NGramHTTPServer", "serve_http"]


class _BadRequest(Exception):
    pass


def _int_list(v, what: str) -> list[int]:
    if not isinstance(v, list) or not all(isinstance(x, int) and
                                          not isinstance(x, bool) for x in v):
        raise _BadRequest(f"{what} must be a list of ints")
    return v


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro_torch-ngram/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:          # tests/benchmarks: silent
        pass

    @property
    def frontend(self):
        return self.server.frontend

    # ------------------------------------------------------------- plumbing

    def _send_json(self, code: int, obj: dict, *,
                   extra_headers: dict | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        try:
            obj = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise _BadRequest(f"invalid JSON body: {e}") from None
        if not isinstance(obj, dict):
            raise _BadRequest("body must be a JSON object")
        return obj

    def _identity(self) -> tuple[str, str]:
        tenant = self.headers.get("X-Tenant", "default")
        priority = self.headers.get("X-Priority", "interactive")
        if priority not in self.frontend.admission.priorities:
            raise _BadRequest(f"unknown priority class {priority!r}")
        return tenant, priority

    def _reject(self, status: str) -> None:
        if status == "quota":
            self._send_json(429, {"error": "tenant quota exhausted"})
        else:
            self._send_json(503, {"error": "overloaded, request shed"},
                            extra_headers={"Retry-After": "1"})

    # ------------------------------------------------------------- GET side

    def do_GET(self) -> None:
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok"})
        elif self.path == "/v1/system/topology":
            self._send_json(200, self.frontend.topology())
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    # ------------------------------------------------------------ POST side

    def do_POST(self) -> None:
        try:
            body = self._read_body()
            tenant, priority = self._identity()
            if self.path == "/v1/lookup":
                self._lookup(body, tenant, priority)
            elif self.path == "/v1/topk":
                self._topk(body, tenant, priority)
            elif self.path == "/v1/complete":
                self._complete(body, tenant, priority)
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})
        except _BadRequest as e:
            self._send_json(400, {"error": str(e)})
        except BrokenPipeError:                    # client went away mid-SSE
            pass

    def _lookup(self, body: dict, tenant: str, priority: str) -> None:
        fe = self.frontend
        if "grams" in body:
            grams = [_int_list(g, "grams[i]") for g in body["grams"]]
            lengths = body.get("lengths")
            if lengths is not None:
                _int_list(lengths, "lengths")
                if len(lengths) != len(grams):
                    raise _BadRequest("lengths must match grams")
            statuses, payloads = fe.call_many(
                "lookup", [self._pad(g) for g in grams],
                lengths if lengths is not None else [len(g) for g in grams],
                tenant=tenant, priority=priority)
            bad = next((s for s in statuses if s in ("shed", "quota")), None)
            if bad:
                self._reject(bad)
                return
            self._send_json(200, {"counts": [int(p) for p in payloads],
                                  "generation": fe.service.gen.generation})
            return
        gram = _int_list(body.get("gram"), "gram")
        status, payload = fe.call("lookup", gram, tenant=tenant,
                                  priority=priority)
        if status in ("shed", "quota"):
            self._reject(status)
            return
        self._send_json(200, {"count": int(payload),
                              "generation": fe.service.gen.generation})

    def _pad(self, gram: list[int]) -> list[int]:
        # fixed sigma-width row so a mixed-length client batch stacks; the
        # true length rides separately (lengths beyond sigma are exact misses)
        sigma = self.frontend.sigma
        return (gram + [0] * sigma)[:sigma]

    def _topk(self, body: dict, tenant: str, priority: str) -> None:
        fe = self.frontend
        prefix = _int_list(body.get("prefix", []), "prefix")
        k = body.get("k", 8)
        if not isinstance(k, int) or not 1 <= k <= 64:
            raise _BadRequest("k must be an int in [1, 64]")
        status, row = fe.call("topk", prefix, len(prefix), k=k, tenant=tenant,
                              priority=priority)
        if status in ("shed", "quota"):
            self._reject(status)
            return
        self._send_json(200, self._topk_json(row, k, fe))

    @staticmethod
    def _topk_json(row, k: int, fe) -> dict:
        return {"n_distinct": int(row[0]), "total": int(row[1]),
                "terms": [int(t) for t in row[2:2 + k]],
                "counts": [int(c) for c in row[2 + k:2 + 2 * k]],
                "generation": fe.service.gen.generation}

    def _complete(self, body: dict, tenant: str, priority: str) -> None:
        """Greedy streaming completion over SSE: one top-1 query per step.

        The prefix window slides over the last sigma-1 emitted tokens, so
        arbitrarily long completions stream from a fixed-sigma index; each
        step is an ordinary admitted/coalesced/shed frontend request, so an
        overload mid-stream ends the stream with an SSE error event instead
        of stalling the connection.
        """
        fe = self.frontend
        prefix = list(_int_list(body.get("prefix", []), "prefix"))
        steps = body.get("steps", 16)
        k = body.get("k", 8)
        if not isinstance(steps, int) or not 1 <= steps <= 512:
            raise _BadRequest("steps must be an int in [1, 512]")
        if not isinstance(k, int) or not 1 <= k <= 64:
            raise _BadRequest("k must be an int in [1, 64]")
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()

        def event(obj) -> None:
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        window = fe.sigma - 1
        for step in range(steps):
            ctx = prefix[-window:] if window else []
            status, row = fe.call("topk", ctx, len(ctx), k=k, tenant=tenant,
                                  priority=priority)
            if status in ("shed", "quota"):
                event({"error": status})
                break
            term, count = int(row[2]), int(row[2 + k])
            if count == 0:
                break
            event({"step": step, "term": term, "count": count})
            prefix.append(term)
        self.wfile.write(b"data: [DONE]\n\n")
        self.wfile.flush()
        self.close_connection = True


class NGramHTTPServer(ThreadingHTTPServer):
    """Threaded HTTP server bound to one :class:`QueryFrontend`."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, address, frontend):
        self.frontend = frontend
        super().__init__(address, _Handler)


def serve_http(frontend, host: str = "127.0.0.1", port: int = 8080, *,
               block: bool = True) -> NGramHTTPServer:
    """Start serving; ``block=False`` runs the accept loop on a daemon thread
    and returns the server (``.server_address`` holds the bound port when 0
    was requested; call ``.shutdown()`` to stop)."""
    srv = NGramHTTPServer((host, port), frontend)
    if block:
        try:
            srv.serve_forever()
        except KeyboardInterrupt:                   # pragma: no cover
            pass
        finally:
            srv.server_close()
        return srv
    t = threading.Thread(target=srv.serve_forever, name="repro_torch-http",
                         daemon=True)
    t.start()
    return srv
