"""Minimal WSGI micro-framework (flask-shaped surface, stdlib only).

Counterpart of ``terrain_diffusion_tpu.serving.httpd``: routing, request
arguments and responses on ``wsgiref``, so the serving layer needs no web
dependency.  Single-threaded by default: the pipeline's tile store is then
never accessed concurrently.
"""
from __future__ import annotations

import json
import traceback
from typing import Callable
from urllib.parse import parse_qs
from wsgiref.simple_server import WSGIServer, make_server, WSGIRequestHandler


class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"]
        self.path = environ["PATH_INFO"]
        # FIRST occurrence of a repeated parameter, matching the reference
        # server's werkzeug args.get semantics
        self._args = {k: v[0] for k, v in
                      parse_qs(environ.get("QUERY_STRING", "")).items()}
        self._body = None

    class _Args:
        def __init__(self, raw):
            self._raw = raw

        def get(self, name, default=None, type=None):
            v = self._raw.get(name)
            if v is None:
                return default
            if type is not None:
                try:
                    return type(v)
                except (TypeError, ValueError):
                    return default
            return v

    @property
    def args(self):
        return self._Args(self._args)

    def get_json(self, silent: bool = True):
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
                self._body = self.environ["wsgi.input"].read(length) if length else b""
            except (TypeError, ValueError):
                self._body = b""
        if not self._body:
            return None
        try:
            return json.loads(self._body)
        except json.JSONDecodeError:
            if silent:
                return None
            raise


class Response:
    def __init__(self, body=b"", status: int = 200, mimetype: str = "text/plain",
                 headers: dict | None = None):
        self.body = body if isinstance(body, (bytes, bytearray)) else str(body).encode()
        self.status = status
        self.headers = dict(headers or {})
        self.headers.setdefault("Content-Type", mimetype)


def jsonify(obj, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), status=status,
                    mimetype="application/json")


_STATUS = {200: "200 OK", 400: "400 Bad Request", 404: "404 Not Found",
           405: "405 Method Not Allowed", 500: "500 Internal Server Error"}


class App:
    def __init__(self, name: str = "app"):
        self.name = name
        self._routes: dict[tuple[str, str], Callable] = {}

    def route(self, path: str, methods=("GET",)):
        def deco(fn):
            for m in methods:
                self._routes[(m.upper(), path)] = fn
            return fn
        return deco

    def get(self, path: str):
        return self.route(path, methods=("GET",))

    def post(self, path: str):
        return self.route(path, methods=("POST",))

    def wsgi(self, environ, start_response):
        req = Request(environ)
        handler = self._routes.get((req.method, req.path))
        if handler is None:
            if any(p == req.path for (_m, p) in self._routes):
                resp = jsonify({"error": "method not allowed"}, 405)
            else:
                resp = jsonify({"error": "not found"}, 404)
        else:
            try:
                out = handler(req)
                if isinstance(out, Response):
                    resp = out
                elif isinstance(out, tuple):
                    body, status = out
                    resp = body if isinstance(body, Response) else jsonify(body, status)
                    resp.status = status
                elif isinstance(out, (dict, list)):
                    resp = jsonify(out)
                else:
                    resp = Response(out)
            except Exception as e:  # noqa: BLE001 — error surface, like flask
                traceback.print_exc()
                resp = jsonify({"error": str(e)}, 500)
        resp.headers["Content-Length"] = str(len(resp.body))
        start_response(_STATUS.get(resp.status, f"{resp.status} "),
                       list(resp.headers.items()))
        return [resp.body]

    def make_server(self, host: str = "0.0.0.0", port: int = 8000,
                    quiet: bool = False):
        """Build (but do not start) a single-threaded WSGI server; port=0
        binds an ephemeral port (``httpd.server_address[1]``)."""
        handler_cls = WSGIRequestHandler
        if quiet:
            class _Quiet(WSGIRequestHandler):
                def log_message(self, *a):
                    pass
            handler_cls = _Quiet
        return make_server(host, port, self.wsgi, server_class=WSGIServer,
                           handler_class=handler_cls)

    def run(self, host: str = "0.0.0.0", port: int = 8000, quiet: bool = False):
        """Serve forever, one request at a time."""
        with self.make_server(host, port, quiet=quiet) as httpd:
            print(f"* Serving {self.name} on http://{host}:{port}")
            httpd.serve_forever()
