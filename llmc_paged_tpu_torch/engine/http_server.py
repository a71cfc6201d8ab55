"""Minimal HTTP serving front (stdlib-only) over ServingEngine (port of
llmc_paged_tpu/engine/http_server.py: the same JSON API and status codes).

Production deployments talk to an endpoint, not a Python API. This is
the thinnest honest version: ThreadingHTTPServer gives one handler
thread per connection; each handler submits to the SHARED ServingEngine
and blocks on its Future — so concurrent HTTP requests batch together
in the engine (continuous batching across connections), which is the
whole point. No auth; binds 127.0.0.1 by default. Handler threads touch
only Python objects (token lists, futures), never a CUDA tensor.

API (JSON over POST/GET):
  POST /generate  {"prompt": [int token ids], "max_new_tokens": N,
                   "stop_tokens": [ids]?, "stream": bool?,
                   "temperature": f?, "top_k": n?, "greedy": bool?,
                   "priority": int? (higher admits sooner),
                   "logprobs": bool?, "prompt_logprobs": bool?,
                   "frequency_penalty": f?, "presence_penalty": f?}
      -> {"tokens": [prompt+generated], "generated": [...],
          "logprobs": [...]?, "prompt_logprobs": [...]?,
          "text": "..."}   (text only when a tokenizer is loaded)
      400 for a malformed or unservable request, 503 with Retry-After
      when max_pending live requests are in flight
  GET  /health    -> {"status": "ok", "pending": n}
  GET  /stats     -> live serving snapshot (running/waiting/finished,
                     decode tok/s, pages free, preemptions, uptime,
                     pending futures / open streams)

A client that disconnects mid-stream CANCELS its request (the handler
sees the broken pipe at the next flush and calls StreamHandle.cancel),
so abandoned streams release their slot and pages promptly.

Prompts are TOKEN IDS: the GPT-2 tokenizer artifact is decode-only
(length-prefixed byte table, train_gpt2.py:353-367 — the reference's
prompts likewise arrive pre-tokenized from the data .bin). `text` in
responses is decoded when a tokenizer is provided.

CLI: `python -m llmc_paged_tpu_torch.engine.cli ... --serve PORT`.

Over tensor-parallel ranks (an engine with EngineConfig.mesh_shape, one
process a rank) ``serve_http`` runs on every rank: the leader of each
model group binds the port and answers clients, the other ranks run the
follower ServingEngine and block until the leader closes
(engine/server.py).
"""

from __future__ import annotations

import json
import signal
import threading
from concurrent.futures import CancelledError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from llmc_paged_tpu_torch.engine.server import QueueFull, ServingEngine


def make_handler(serving: ServingEngine, tokenizer=None):
    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the engine has its own structured logging
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                return self._reply(200, serving.stats())
            if self.path != "/health":
                return self._reply(404, {"error": "unknown path"})
            with serving._lock:
                pending = len(serving._futures)
            self._reply(200, {"status": "ok", "pending": pending})

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                max_new = int(req.get("max_new_tokens", 16))
                stop = req.get("stop_tokens")
                if not (isinstance(prompt, list)
                        and all(isinstance(t, int) for t in prompt)):
                    raise ValueError("prompt must be a list of token ids")
                if stop is not None and not (
                        isinstance(stop, list)
                        and all(isinstance(t, int) for t in stop)):
                    raise ValueError("stop_tokens must be a list of ids")
                # per-request sampling overrides (None = engine default)
                temp = req.get("temperature")
                temp = None if temp is None else float(temp)
                top_k = req.get("top_k")
                top_k = None if top_k is None else int(top_k)
                greedy = req.get("greedy")
                if greedy is not None and not isinstance(greedy, bool):
                    raise ValueError("greedy must be a boolean")
                pr = req.get("priority", 0)
                if not isinstance(pr, int) or isinstance(pr, bool):
                    raise ValueError("priority must be an integer")
                lp = req.get("logprobs", False)
                if not isinstance(lp, bool):
                    raise ValueError("logprobs must be a boolean")
                plp = req.get("prompt_logprobs", False)
                if not isinstance(plp, bool):
                    raise ValueError("prompt_logprobs must be a boolean")
                fp = float(req.get("frequency_penalty", 0.0))
                pp = float(req.get("presence_penalty", 0.0))
                samp = {"temperature": temp, "top_k": top_k,
                        "greedy": greedy, "priority": pr, "logprobs": lp,
                        "prompt_logprobs": plp,
                        "frequency_penalty": fp, "presence_penalty": pp}
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                # TypeError covers type-malformed JSON (body '[1,2]' →
                # req["prompt"]; "max_new_tokens": null → int(None)) —
                # without it the handler thread dies and the client sees
                # a reset instead of the 400
                return self._reply(400, {"error": str(e)})
            if req.get("stream"):
                return self._stream(prompt, max_new, stop, samp)
            try:
                fut = serving.submit(prompt, max_new, stop_tokens=stop,
                                     **samp)
                tokens = fut.result()
            except QueueFull as e:
                return self._reply(503, {"error": str(e)},
                                   headers={"Retry-After": "1"})
            except CancelledError:
                # serve_http cancels what is live when the server stops
                return self._reply(503, {"error": "cancelled: the server "
                                                  "is stopping"})
            except (ValueError, RuntimeError) as e:
                # invalid request (too long for the pool, ...) or loop down
                return self._reply(400, {"error": str(e)})
            out = {"tokens": tokens, "generated": tokens[len(prompt):]}
            if samp["logprobs"]:
                out["logprobs"] = fut.request.logprob_values
            if samp["prompt_logprobs"]:
                out["prompt_logprobs"] = fut.request.prompt_logprob_values
            if tokenizer is not None:
                out["text"] = tokenizer.decode_string(out["generated"])
            self._reply(200, out)

        def _stream(self, prompt, max_new, stop=None, samp=None):
            """Newline-delimited JSON, close-delimited (HTTP/1.0-style):
            one {"tokens": [...]} line per engine flush, then a final
            {"done": true, ...} line. Flush granularity is decode-chain
            links (EngineConfig.stream_links)."""
            try:
                it = serving.submit_stream(prompt, max_new,
                                           stop_tokens=stop,
                                           **(samp or {}))
            except QueueFull as e:
                return self._reply(503, {"error": str(e)},
                                   headers={"Retry-After": "1"})
            except (ValueError, RuntimeError) as e:
                return self._reply(400, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")
            self.end_headers()
            generated = []
            try:
                for batch in it:
                    generated.extend(batch)
                    line = {"tokens": batch}
                    if tokenizer is not None:
                        line["text"] = tokenizer.decode_string(batch)
                    self.wfile.write((json.dumps(line) + "\n").encode())
                    self.wfile.flush()
                final = {"done": True, "generated": generated}
                if samp and samp.get("logprobs"):
                    final["logprobs"] = it.request.logprob_values
                self.wfile.write((json.dumps(final) + "\n").encode())
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-stream: abort the request so its
                # slot and pages free now instead of decoding the rest of
                # max_new_tokens for nobody
                it.cancel()
                for _ in it:     # drain so the engine's flushes never block
                    pass

    return Handler


class HttpServingFront:
    """Owns the HTTP server thread; the caller owns the ServingEngine."""

    def __init__(self, serving: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, tokenizer=None):
        self._httpd = ThreadingHTTPServer(
            (host, port), make_handler(serving, tokenizer))
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="llmc-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve_http(engine, host: str = "127.0.0.1", port: int = 8000,
               tokenizer=None, window: Optional[int] = None,
               max_pending: Optional[int] = None):
    """Blocking entry point (the CLI --serve path): run the engine's
    serving loop with an HTTP front until interrupted (SIGINT, or SIGTERM
    when called from the main thread). On the way out the live requests
    are cancelled and the loop ends on every rank. Under TP, call it on
    every rank: only a leader binds the port; a follower returns when its
    leader closes."""
    term = None
    if threading.current_thread() is threading.main_thread():
        term = signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        serving = ServingEngine(engine, window=window,
                                max_pending=max_pending)
        if not serving.is_leader:
            try:
                serving.close()             # until the leader closes
            except KeyboardInterrupt:
                serving.close()             # which its own signal makes it
            if serving._error is not None:  # the leader is gone
                raise RuntimeError("the serving loop ended on an error"
                                   ) from serving._error
            return
        front = None
        try:
            front = HttpServingFront(serving, host, port, tokenizer)
            print(f"serving on http://{front.host}:{front.port} "
                  f"(POST /generate, GET /health)", flush=True)
            serving._done.wait()            # until interrupted
        except KeyboardInterrupt:
            pass
        finally:
            if front is not None:
                front.close()
            serving.cancel_all()
            serving.close()
    finally:
        if term is not None:
            signal.signal(signal.SIGTERM, term)
