"""HTTP front end for the serving engine (stdlib only).

A copy of hirest_tpu/serve/server.py over the port's engine.

Endpoints:
  GET  /health                          -> engine + device status
  POST /v1/retrieve {"prompt", "top_k"} -> ranked videos
  POST /v1/analyze  {"prompt", "video"} -> moment bounds + step captions

Single-process, threaded HTTP; device work is serialized inside the engine,
so concurrent requests queue rather than race.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from hirest_tpu_torch.serve.engine import ServingEngine


def make_server(engine: ServingEngine, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/health":
                self._send(200, engine.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad request body: {e}"})
                return

            try:
                if self.path == "/v1/retrieve":
                    if "prompt" not in req:
                        self._send(400, {"error": "missing 'prompt'"})
                        return
                    try:
                        top_k = int(req.get("top_k", 10))
                        if top_k < 1:
                            raise ValueError("top_k must be >= 1")
                    except (TypeError, ValueError) as e:
                        # client input error, not a server fault (and a
                        # negative top_k would silently slice the WORST
                        # results via argsort[:-k])
                        self._send(400, {"error": f"bad top_k: {e}"})
                        return
                    self._send(200, engine.retrieve(req["prompt"], top_k))
                elif self.path == "/v1/analyze":
                    missing = [k for k in ("prompt", "video") if k not in req]
                    if missing:
                        self._send(400, {"error": f"missing {missing}"})
                        return
                    self._send(200, engine.analyze(req["prompt"], req["video"],
                                                   req.get("video_duration")))
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except FileNotFoundError as e:
                self._send(404, {"error": str(e)})
            except Exception as e:  # surface, don't crash the server
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
