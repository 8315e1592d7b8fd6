"""Streaming HTTP front end over the serving engine.

Counterpart of ``repro.serving.frontend``: an OpenAI-style ``POST
/v1/completions`` on top of the engine's ``submit()``/``on_token`` API,
the piece between an engine that drains a queue and a service that takes
traffic. Stdlib only: a hand-written HTTP/1.1 parser on
``asyncio.start_server``, and no tokenizer, so ``prompt`` is a list of
token ids (which the OpenAI completions schema allows).

Threads. The engine is single-threaded and blocking (``run()`` owns the
device), so three parties cooperate:

* the **engine thread** blocks on an inbox ``queue.SimpleQueue`` while
  idle; on any command it drains the inbox and calls
  ``engine.run(poll=...)``, whose ``poll`` drains the inbox again every
  scheduler iteration, so arrivals and cancels land between chunks. All
  device work happens on this thread. It is not the thread that built
  the engine, and a CUDA stream is per thread: the engine thread runs on
  the stream that was current where the ``Frontend`` was made (build the
  engine and the front end on one thread), the stream the engine's
  tensors were made on, and records it in ``engine_stream``.
* the **asyncio loop thread** owns the listening socket and the client
  connections. Its handlers never touch the engine or a tensor: they
  enqueue ``("submit", ...)``/``("cancel", rid)`` commands and await a
  per-request ``asyncio.Queue``, which engine-side callbacks feed through
  ``loop.call_soon_threadsafe`` (the only cross-thread hop).
* the **caller's thread**: ``start()``/``close()``.

Per request: ``priority`` and ``deadline_s`` pass through to ``submit``;
``timeout_s`` (default ``FrontendConfig.request_timeout_s``) is enforced
on the engine thread, where an overdue request is cancelled through
``cancel()`` and finishes with ``finish_reason: "timeout"``, keeping the
tokens it streamed. A client that disconnects mid-stream is cancelled the
same way. ``EngineSaturated`` (a bounded queue, a saturated page pool)
maps to HTTP 429 with the machine-readable reason in the body. It serves
an ``Engine`` or a ``DisaggEngine``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import heapq
import json
import queue as queue_mod
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.serving.engine import EngineSaturated

_JSON = "application/json"


@dataclasses.dataclass
class FrontendConfig:
    host: str = "127.0.0.1"
    port: int = 0                       # 0 -> ephemeral (read .port after
                                        # start(); what the tests use)
    model_name: str = "repro_torch"     # echoed in completion payloads
    request_timeout_s: float = 120.0    # per-request wall ceiling
                                        # (overridable per request)
    idle_wait_s: float = 0.02           # engine-thread inbox block while
                                        # the engine is idle
    max_tokens_default: int = 16


class _Pending:
    """Async-side handle for one in-flight completion. The engine thread
    posts ("rid"|"tok"|"done"|"err", payload) events into ``q`` via
    call_soon_threadsafe; flags written on the engine thread before the
    terminal event are read by the handler after it (happens-before via
    the queue hop)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self.q: asyncio.Queue = asyncio.Queue()
        self.rid: Optional[int] = None
        self.timed_out = False

    def post(self, kind: str, payload: Any = None) -> None:
        self.loop.call_soon_threadsafe(self.q.put_nowait, (kind, payload))


class Frontend:
    """HTTP front-end over an ``Engine`` (or ``DisaggEngine``: anything
    with submit/cancel/run/stats and the SLO submit fields)."""

    def __init__(self, engine, fcfg: Optional[FrontendConfig] = None):
        self.engine = engine
        self.fcfg = fcfg or FrontendConfig()
        self.port: Optional[int] = None
        self.stats: Dict[str, int] = dict(
            http_requests=0, completions=0, rejected=0, timeouts=0,
            disconnects=0, streamed_tokens=0)
        self._inbox: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._timeouts: List = []       # heap of (wall_deadline, rid, pend)
        self._shutdown = threading.Event()
        self._started = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._loop_thread = threading.Thread(
            target=self._loop_main, name="frontend-http", daemon=True)
        self._engine_thread = threading.Thread(
            target=self._engine_main, name="frontend-engine", daemon=True)
        # the stream current on this (the engine's) thread; the engine
        # thread runs on it. None on the CPU.
        dev = torch.device(getattr(engine, "device", "cpu"))
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        self.engine_stream = None       # the engine thread's stream, for
                                        # a caller to check against

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Frontend":
        self._loop_thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("HTTP front-end failed to start listening")
        self._engine_thread.start()
        return self

    def close(self) -> None:
        self._shutdown.set()
        self._inbox.put(("wake", None))
        self._engine_thread.join(timeout=30)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop_loop)
        self._loop_thread.join(timeout=10)

    def _stop_loop(self) -> None:
        if self._server is not None:
            self._server.close()
        self._loop.stop()

    def _loop_main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._serve_conn, self.fcfg.host, self.fcfg.port)
            self.port = self._server.sockets[0].getsockname()[1]

        self._loop.run_until_complete(boot())
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    # -- engine thread -------------------------------------------------------
    def _engine_main(self) -> None:
        if self._stream is None:
            self._engine_loop()
            return
        with torch.cuda.device(self._stream.device), \
                torch.cuda.stream(self._stream):
            self.engine_stream = torch.cuda.current_stream(
                self._stream.device)
            self._engine_loop()

    def _engine_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                item = self._inbox.get(timeout=self.fcfg.idle_wait_s)
            except queue_mod.Empty:
                self._check_timeouts()
                continue
            self._apply(item)
            self._drain_inbox()
            if self._shutdown.is_set():
                break
            # run() returns once queue + slots drain; poll keeps feeding
            # it mid-cycle arrivals until then
            self.engine.run(poll=self._poll)

    def _poll(self) -> None:
        self._drain_inbox()
        self._check_timeouts()

    def _drain_inbox(self) -> None:
        while True:
            try:
                self._apply(self._inbox.get_nowait())
            except queue_mod.Empty:
                return

    def _apply(self, item) -> None:
        kind, payload = item
        if kind == "submit":
            self._apply_submit(payload)
        elif kind == "cancel":
            self.engine.cancel(payload)

    def _apply_submit(self, spec: Dict[str, Any]) -> None:
        pend: _Pending = spec["pending"]

        def on_token(_rid: int, tok: int) -> None:
            self.stats["streamed_tokens"] += 1
            pend.post("tok", tok)

        def on_done(req) -> None:
            pend.post("done", dict(
                tokens=list(req.tokens), cancelled=req.cancelled,
                preempted=req.preempted, ttft_s=req.ttft_s,
                queue_wait_s=req.queue_wait_s,
                deadline_missed=req.deadline_missed))

        try:
            rid = self.engine.submit(
                spec["prompt"], max_new_tokens=spec["max_tokens"],
                on_token=on_token, priority=spec["priority"],
                deadline_s=spec["deadline_s"], on_done=on_done)
        except (EngineSaturated, ValueError) as e:
            pend.post("err", e)
            return
        pend.rid = rid
        if spec["timeout_s"] is not None:
            heapq.heappush(self._timeouts,
                           (time.perf_counter() + spec["timeout_s"],
                            rid, pend))
        pend.post("rid", rid)

    def _check_timeouts(self) -> None:
        now = time.perf_counter()
        while self._timeouts and self._timeouts[0][0] <= now:
            _, rid, pend = heapq.heappop(self._timeouts)
            # the flag must be visible before cancel() fires on_done (the
            # handler reads it after the done event); reset on a failed
            # cancel so a request that finished just under the wire is
            # not mislabeled "timeout"
            pend.timed_out = True
            if self.engine.cancel(rid):
                self.stats["timeouts"] += 1
            else:
                pend.timed_out = False

    # -- HTTP layer (asyncio loop thread) ------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                reqline = await reader.readline()
                if not reqline or reqline in (b"\r\n", b"\n"):
                    break
                try:
                    method, path, _ = reqline.decode("latin-1").split()
                except ValueError:
                    break
                headers: Dict[str, str] = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                body = b""
                n = int(headers.get("content-length", "0") or 0)
                if n:
                    body = await reader.readexactly(n)
                self.stats["http_requests"] += 1
                keep = await self._route(method, path, body, reader,
                                         writer)
                if not keep or headers.get("connection", "") == "close":
                    break
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError,
                BrokenPipeError, asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     reader, writer) -> bool:
        """Dispatch one request; returns False when the connection must
        close (streaming responses end the connection)."""
        if method == "POST" and path == "/v1/completions":
            return await self._completions(body, reader, writer)
        if method == "GET" and path == "/health":
            self._respond(writer, 200, dict(
                status="ok", model=self.fcfg.model_name,
                queue_depth=len(getattr(self.engine, "_queue", ()))))
            return True
        if method == "GET" and path == "/v1/models":
            self._respond(writer, 200, dict(
                object="list",
                data=[dict(id=self.fcfg.model_name, object="model",
                           owned_by="repro_torch")]))
            return True
        if method == "GET" and path == "/stats":
            self._respond(writer, 200, dict(
                frontend=dict(self.stats),
                engine={k: v for k, v in self.engine.stats.items()
                        if not isinstance(v, dict)}))
            return True
        self._respond(writer, 404, dict(error=dict(
            message=f"no route for {method} {path}", type="not_found")))
        return True

    async def _completions(self, body: bytes, reader, writer) -> bool:
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError:
            self._respond(writer, 400, _err("body is not valid JSON",
                                            "invalid_request_error"))
            return True
        prompt = payload.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt)):
            self._respond(writer, 400, _err(
                "prompt must be a non-empty list of token ids (no "
                "tokenizer is mounted; the OpenAI completions schema "
                "allows token-id prompts)", "invalid_request_error"))
            return True
        try:
            max_tokens = int(payload.get("max_tokens",
                                         self.fcfg.max_tokens_default))
            priority = int(payload.get("priority", 0))
            deadline_s = payload.get("deadline_s")
            deadline_s = None if deadline_s is None else float(deadline_s)
            timeout_s = payload.get("timeout_s",
                                    self.fcfg.request_timeout_s)
            timeout_s = None if timeout_s is None else float(timeout_s)
            stream = bool(payload.get("stream", False))
        except (TypeError, ValueError):
            self._respond(writer, 400, _err(
                "max_tokens/priority/deadline_s/timeout_s must be numbers",
                "invalid_request_error"))
            return True

        pend = _Pending(asyncio.get_running_loop())
        self._inbox.put(("submit", dict(
            prompt=list(prompt), max_tokens=max_tokens, priority=priority,
            deadline_s=deadline_s, timeout_s=timeout_s, pending=pend)))
        # generous hard ceiling so a wedged engine can't hang the handler
        wait_s = (timeout_s or self.fcfg.request_timeout_s) + 60.0
        kind, payload0 = await asyncio.wait_for(pend.q.get(), wait_s)
        if kind == "err":
            exc = payload0
            if isinstance(exc, EngineSaturated):
                self.stats["rejected"] += 1
                self._respond(writer, 429, dict(error=dict(
                    message=str(exc), type="engine_saturated",
                    reason=exc.reason, detail=exc.detail)))
            else:
                self._respond(writer, 400, _err(str(exc),
                                                "invalid_request_error"))
            return True
        assert kind == "rid", kind
        rid = payload0
        if stream:
            return await self._stream_response(rid, len(prompt), pend,
                                               reader, writer, wait_s)
        return await self._plain_response(rid, len(prompt), pend, writer,
                                          wait_s)

    async def _plain_response(self, rid: int, n_prompt: int,
                              pend: _Pending, writer,
                              wait_s: float) -> bool:
        toks: List[int] = []
        info = None
        while info is None:
            kind, payload = await asyncio.wait_for(pend.q.get(), wait_s)
            if kind == "tok":
                toks.append(payload)
            elif kind == "done":
                info = payload
        self.stats["completions"] += 1
        self._respond(writer, 200, self._completion_obj(
            rid, n_prompt, info, info["tokens"],
            self._finish_reason(pend, info)))
        return True

    async def _stream_response(self, rid: int, n_prompt: int,
                               pend: _Pending, reader, writer,
                               wait_s: float) -> bool:
        """Server-sent events, one chunk per token. Closes the connection
        when done (Connection: close framing -- no chunked encoding).
        Client disconnects surface as write errors on the next token;
        the handler then cancels through the ordinary inbox path."""
        head = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n"
                b"Connection: close\r\n\r\n")
        writer.write(head)
        try:
            await writer.drain()
            while True:
                kind, payload = await asyncio.wait_for(pend.q.get(),
                                                       wait_s)
                if kind == "tok":
                    chunk = self._sse_obj(rid, token_id=payload)
                    writer.write(b"data: " + json.dumps(chunk).encode()
                                 + b"\n\n")
                    await writer.drain()
                elif kind == "done":
                    fin = self._sse_obj(
                        rid, finish_reason=self._finish_reason(
                            pend, payload),
                        usage=dict(prompt_tokens=n_prompt,
                                   completion_tokens=len(
                                       payload["tokens"]),
                                   total_tokens=n_prompt
                                   + len(payload["tokens"])))
                    writer.write(b"data: " + json.dumps(fin).encode()
                                 + b"\n\ndata: [DONE]\n\n")
                    await writer.drain()
                    self.stats["completions"] += 1
                    return False
        except (ConnectionError, BrokenPipeError, asyncio.TimeoutError):
            self.stats["disconnects"] += 1
            if pend.rid is not None:
                self._inbox.put(("cancel", pend.rid))
            return False

    # -- payload shaping -----------------------------------------------------
    def _finish_reason(self, pend: _Pending, info: Dict[str, Any]) -> str:
        if pend.timed_out:
            return "timeout"
        if info["preempted"]:
            return "preempted"
        if info["cancelled"]:
            return "cancelled"
        return "length"

    def _completion_obj(self, rid: int, n_prompt: int, info, toks,
                        finish_reason: str) -> Dict[str, Any]:
        return dict(
            id=f"cmpl-{rid}", object="text_completion",
            created=int(time.time()), model=self.fcfg.model_name,
            choices=[dict(index=0, text="", token_ids=list(toks),
                          finish_reason=finish_reason)],
            usage=dict(prompt_tokens=n_prompt,
                       completion_tokens=len(toks),
                       total_tokens=n_prompt + len(toks)),
            timing=dict(ttft_s=info["ttft_s"],
                        queue_wait_s=info["queue_wait_s"],
                        deadline_missed=info["deadline_missed"]))

    def _sse_obj(self, rid: int, token_id: Optional[int] = None,
                 finish_reason: Optional[str] = None,
                 usage: Optional[Dict] = None) -> Dict[str, Any]:
        choice: Dict[str, Any] = dict(index=0, text="",
                                      finish_reason=finish_reason)
        if token_id is not None:
            choice["token_id"] = token_id
        obj = dict(id=f"cmpl-{rid}", object="text_completion",
                   model=self.fcfg.model_name, choices=[choice])
        if usage is not None:
            obj["usage"] = usage
        return obj

    @staticmethod
    def _respond(writer, status: int, obj: Dict[str, Any]) -> None:
        phrase = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests"}.get(status, "Error")
        data = json.dumps(obj).encode()
        writer.write(
            f"HTTP/1.1 {status} {phrase}\r\n"
            f"Content-Type: {_JSON}\r\n"
            f"Content-Length: {len(data)}\r\n\r\n".encode() + data)


def _err(message: str, etype: str) -> Dict[str, Any]:
    return dict(error=dict(message=message, type=etype))


def serve_forever(engine, fcfg: Optional[FrontendConfig] = None) -> None:
    """Blocking entry point for ``launch/serve.py --http``: start the
    front-end and sleep until interrupted."""
    fe = Frontend(engine, fcfg).start()
    print(f"serving on http://{fe.fcfg.host}:{fe.port} "
          f"(model={fe.fcfg.model_name!r}); POST /v1/completions with a "
          "token-id prompt; GET /health, /v1/models, /stats")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        fe.close()
