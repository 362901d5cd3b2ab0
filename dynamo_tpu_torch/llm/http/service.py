"""OpenAI-compatible HTTP frontend on ``asyncio.start_server``.

Routes: POST /v1/chat/completions, POST /v1/completions (streaming SSE and
unary), GET /v1/models, GET /health, GET /live, GET /metrics, and the debug
routes GET /debug/traces, /debug/slo and /debug/profile (query strings
parsed with ``urllib.parse``). HTTP/1.1 with one request per connection
(``Connection: close``); streamed responses use chunked transfer encoding,
one SSE frame per chunk. The engine is always called streaming; unary
requests fold the chunk stream through the aggregators. A client that goes
away kills the engine context.

The observability planes of the JAX package's ``llm/http/service.py``
(aiohttp) run here by default as they do there: every OpenAI request is
counted by an ``InflightGuard`` (``metrics.py``: request counters,
inflight, duration, TTFT and ITL histograms, fed to the SLO store) and
traced by an ``http.edge`` span, parented under the request's W3C
``traceparent`` header when it carries a valid one; the span rides the
engine context into the engine. With ``DYN_TPU_PROFILE`` armed the stream
loop splits its per-token CPU into serialize and transport-write, and an
event-loop lag sampler runs beside the server. Not here yet: the JAX
edge's QoS gate (tenants, rate limits) and its discovery-backed health.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ...runtime import profiling, telemetry, tracing
from ...runtime.annotated import Annotated
from ...runtime.engine import AsyncEngine, Context
from ..protocols.common import HttpError
from ..protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    aggregate_chat_chunks,
    aggregate_completion_chunks,
    model_list,
)
from ..protocols.sse import DONE_SENTINEL, SseMessage
from .metrics import InflightGuard, ServiceMetrics

logger = logging.getLogger(__name__)

MAX_BODY = 16 << 20
_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    411: "Length Required", 413: "Payload Too Large", 500: "Internal Server Error",
    502: "Bad Gateway",
}


class ModelManager:
    """Registry of model name → engine, per endpoint type. Engines take
    OpenAI requests and yield Annotated chunk dicts."""

    def __init__(self) -> None:
        self._chat: dict[str, AsyncEngine] = {}
        self._completions: dict[str, AsyncEngine] = {}

    def add_chat_model(self, name: str, engine: AsyncEngine) -> None:
        self._chat[name] = engine

    def add_completions_model(self, name: str, engine: AsyncEngine) -> None:
        self._completions[name] = engine

    def chat_engine(self, name: str) -> AsyncEngine:
        try:
            return self._chat[name]
        except KeyError:
            raise HttpError(404, f"model {name!r} not found") from None

    def completions_engine(self, name: str) -> AsyncEngine:
        try:
            return self._completions[name]
        except KeyError:
            raise HttpError(404, f"model {name!r} not found") from None

    def model_names(self) -> list[str]:
        return sorted(set(self._chat) | set(self._completions))


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


async def _read_request(reader: asyncio.StreamReader) -> Tuple[str, str, dict, bytes]:
    """Parse one HTTP/1.1 request: (method, target, headers, body); the
    target keeps its query string."""
    line = await reader.readline()
    if not line:
        raise ConnectionResetError("client closed before sending a request")
    try:
        method, target, _version = line.decode("latin-1").rstrip("\r\n").split(" ", 2)
    except ValueError:
        raise _BadRequest(400, "malformed request line") from None
    headers: dict = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise _BadRequest(411, "chunked request bodies are not supported")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise _BadRequest(400, "invalid Content-Length") from None
    if length < 0 or length > MAX_BODY:
        raise _BadRequest(413, "request body too large")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), target, headers, body


def _query_flag(query: dict, name: str) -> bool:
    """``?name=1`` style flags: anything but absent, empty, 0 or false."""
    return query.get(name, [""])[0] not in ("", "0", "false")


def _head(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _json_bytes(status: int, payload) -> bytes:
    return _body_bytes(status, json.dumps(payload).encode(), "application/json")


def _body_bytes(status: int, body: bytes, content_type: str) -> bytes:
    return _head(status, {
        "Content-Type": content_type, "Content-Length": str(len(body)),
        "Connection": "close",
    }) + body


def _error_bytes(status: int, message: str) -> bytes:
    return _json_bytes(status, {"error": {
        "message": message,
        "type": "invalid_request_error" if status < 500 else "internal_error",
    }})


def _chunk(data: bytes) -> bytes:
    """One chunk of a chunked-transfer body."""
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


class HttpService:
    def __init__(self, manager: Optional[ModelManager] = None, host: str = "0.0.0.0",
                 port: int = 8080):
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self.metrics = ServiceMetrics()
        self._server: Optional[asyncio.base_events.Server] = None
        # profiling plane: with DYN_TPU_PROFILE armed, the stream loop
        # attributes per-token CPU to serialize/transport-write and an
        # event-loop lag sampler runs beside the server. None/off costs one
        # None-check per chunk
        self._fcpu = profiling.frontend_cpu() if profiling.enabled() else None
        self._lag_sampler = None

    async def start(self) -> int:
        """Start serving; returns the bound port."""
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("HTTP service listening on %s:%d", self.host, self.port)
        if self._fcpu is not None and self._lag_sampler is None:
            # one sampler per process, shared by services on the same loop
            self._lag_sampler = profiling.lag_sampler()
            self._lag_sampler.start()
        return self.port

    async def stop(self) -> None:
        if self._lag_sampler is not None:
            self._lag_sampler.stop()
            self._lag_sampler = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def run(self, cancel_event: Optional[asyncio.Event] = None) -> None:
        await self.start()
        try:
            if cancel_event is None:
                await asyncio.Event().wait()
            else:
                await cancel_event.wait()
        finally:
            await self.stop()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, target, headers, body = await _read_request(reader)
            except _BadRequest as e:
                writer.write(_error_bytes(e.status, str(e)))
                return
            except (ConnectionResetError, asyncio.IncompleteReadError):
                return
            await self._route(method, target, headers, body, writer)
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            logger.exception("HTTP handler failed")
            with contextlib.suppress(ConnectionError):
                writer.write(_error_bytes(500, "internal error"))
        finally:
            with contextlib.suppress(ConnectionError, OSError):
                await writer.drain()
                writer.close()
                await writer.wait_closed()

    async def _route(self, method: str, target: str, headers: dict, body: bytes,
                     writer) -> None:
        url = urlsplit(target)
        path, query = url.path, parse_qs(url.query)
        if path in ("/v1/chat/completions", "/v1/completions"):
            if method != "POST":
                writer.write(_error_bytes(405, "use POST"))
                return
            await self._handle_openai(body, headers, writer,
                                      chat=path.endswith("chat/completions"))
            return
        get = {
            "/v1/models": lambda: _json_bytes(200, model_list(self.manager.model_names())),
            "/health": self._health,
            # pure process liveness: never coupled to upstream health
            "/live": lambda: _json_bytes(200, {"live": True}),
            "/metrics": lambda: _body_bytes(200, self.metrics.render().encode(), "text/plain"),
            "/debug/traces": lambda: self._debug_traces(query),
            "/debug/slo": lambda: _json_bytes(200, telemetry.dump_state()),
            "/debug/profile": lambda: self._debug_profile(query),
        }.get(path)
        if get is not None and method == "GET":
            writer.write(get())
        else:
            writer.write(_error_bytes(404, f"no route {method} {path}"))

    def _health(self) -> bytes:
        models = {n: {"status": "healthy"} for n in self.manager.model_names()}
        return _json_bytes(200, {"status": "healthy", "models": models})

    @staticmethod
    def _debug_traces(query: dict) -> bytes:
        """Flight-recorder export: one JSON object per line per trace
        (``?limit=N`` keeps the newest N, ``?trace_id=...`` one trace,
        ``?errored=1`` only traces with a non-ok span)."""
        try:
            limit = int(query.get("limit", ["0"])[0])
        except ValueError:
            limit = 0
        trace_id = query.get("trace_id", [None])[0]
        body = tracing.recorder().dump_jsonl(
            limit=limit, trace_id=trace_id, errored=_query_flag(query, "errored"),
        )
        return _body_bytes(200, (body + ("\n" if body else "")).encode(), "application/jsonl")

    @staticmethod
    def _debug_profile(query: dict) -> bytes:
        """Performance-attribution export: the dispatch timeline summary,
        the frontend per-token CPU split and the event-loop lag gauges;
        ``?trace=1`` returns the same window as a Perfetto-loadable
        Chrome-trace JSON, ``?seconds=N`` restricts to the last N seconds.
        With ``DYN_TPU_PROFILE`` off it answers ``enabled: false`` with
        empty sections."""
        try:
            since = float(query.get("seconds", ["0"])[0]) or None
        except ValueError:
            since = None
        state = profiling.dump_state(since)
        if _query_flag(query, "trace"):
            return _json_bytes(200, profiling.to_chrome_trace([(
                "frontend", state.get("records", []), state.get("events", []),
            )]))
        state.pop("records", None)  # summary view: keep the payload small
        state.pop("events", None)
        return _json_bytes(200, state)

    async def _handle_openai(self, body: bytes, headers: dict, writer, chat: bool) -> None:
        try:
            raw = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            writer.write(_error_bytes(400, "invalid JSON body"))
            return
        try:
            oai_req = (
                ChatCompletionRequest.from_dict(raw) if chat
                else CompletionRequest.from_dict(raw)
            )
        except ValueError as e:
            writer.write(_error_bytes(400, f"invalid request: {e}"))
            return
        try:
            engine = (
                self.manager.chat_engine(oai_req.model) if chat
                else self.manager.completions_engine(oai_req.model)
            )
        except HttpError as e:
            writer.write(_error_bytes(e.status, e.message))
            return
        ctx = Context(oai_req)
        endpoint = "chat/completions" if chat else "completions"
        streaming = bool(oai_req.stream)
        # edge span: the trace's root, or a child of the caller's context
        # when a valid W3C traceparent header arrives (a malformed one just
        # starts a fresh root). It rides ctx.context.trace into the engine;
        # the contextvars make every log line of this handler carry the ids
        edge = tracing.start_span(
            "http.edge",
            parent=tracing.parse_traceparent(headers.get("traceparent")),
            attributes={"model": oai_req.model, "endpoint": endpoint,
                        "stream": streaming, "request_id": ctx.id},
        )
        tokens = None
        if edge is not None:
            ctx.context.trace = edge
            tokens = (tracing.set_current(edge), tracing.set_request_id(ctx.id))
        guard = self.metrics.inflight_guard(
            oai_req.model, endpoint, "stream" if streaming else "unary")
        try:
            with guard:
                if streaming:
                    await self._stream_response(engine, ctx, guard, writer, chat)
                else:
                    await self._unary_response(engine, ctx, guard, writer, chat)
        finally:
            if edge is not None:
                edge.end(_EDGE_STATUS.get(guard.status, guard.status))
            if tokens is not None:
                tracing.reset_current(tokens[0])
                tracing.reset_request_id(tokens[1])

    async def _stream_response(self, engine: AsyncEngine, ctx: Context, guard: InflightGuard,
                               writer, chat: bool) -> None:
        # pull the first item before sending headers, so validation errors
        # still surface as HTTP status codes
        it = engine.generate(ctx).__aiter__()
        try:
            first = await it.__anext__()
        except StopAsyncIteration:
            first = None
        except HttpError as e:
            writer.write(_error_bytes(e.status, e.message))
            return
        if isinstance(first, Annotated) and first.is_error:
            writer.write(_error_bytes(502, first.error_message() or "upstream failure"))
            return
        writer.write(_head(200, {
            "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
            "Transfer-Encoding": "chunked", "Connection": "close",
        }))
        envelope: Optional[dict] = None

        async def frames():
            if first is not None:
                yield first
            async for i in it:
                yield i

        try:
            async for item in frames():
                if isinstance(item, Annotated):
                    if item.is_error:
                        msg = SseMessage(event="error", data=json.dumps(
                            {"message": item.error_message()}))
                        writer.write(_chunk((msg.encode() + "\n\n").encode()))
                        writer.write(_chunk(_error_finish(envelope, chat)))
                        break
                    if item.data is None:
                        writer.write(_chunk((SseMessage.from_annotated(item).encode() + "\n\n").encode()))
                        continue
                    payload = item.data
                else:
                    payload = item
                if isinstance(payload, dict) and envelope is None:
                    envelope = {k: payload[k] for k in ("id", "object", "created", "model")
                                if k in payload}
                has_content = _chunk_has_content(payload)
                if has_content:
                    guard.mark_chunk()  # TTFT on the first, the inter-token gap after
                    guard.count_tokens()
                if self._fcpu is None:
                    writer.write(_chunk(f"data: {json.dumps(payload)}\n\n".encode()))
                    await writer.drain()
                else:
                    # profiling: split the SSE hot path into serialize and
                    # transport-write
                    t0 = time.perf_counter()
                    data = _chunk(f"data: {json.dumps(payload)}\n\n".encode())
                    t1 = time.perf_counter()
                    writer.write(data)
                    await writer.drain()
                    t2 = time.perf_counter()
                    n = 1 if has_content else 0
                    self._fcpu.note("serialize", (t1 - t0) * 1e6, tokens=n)
                    self._fcpu.note("transport_write", (t2 - t1) * 1e6, tokens=n)
                    if tracing.enabled():
                        tracing.observe_phase("serialize", t1 - t0)
            else:
                guard.mark_ok()
            writer.write(_chunk(f"data: {DONE_SENTINEL}\n\n".encode()))
            writer.write(b"0\r\n\r\n")
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            ctx.context.kill()
            logger.info("client disconnected, killed request %s", ctx.id)
            raise
        except Exception as e:  # headers already sent: the error goes in-band
            logger.exception("engine error mid-stream for request %s", ctx.id)
            ctx.context.kill()
            msg = SseMessage(event="error", data=json.dumps({"message": str(e)}))
            writer.write(_chunk((msg.encode() + "\n\n").encode()))
            writer.write(_chunk(_error_finish(envelope, chat)))
            writer.write(_chunk(f"data: {DONE_SENTINEL}\n\n".encode()))
            writer.write(b"0\r\n\r\n")

    async def _unary_response(self, engine: AsyncEngine, ctx: Context, guard: InflightGuard,
                              writer, chat: bool) -> None:
        chunks: list[dict] = []
        n_tokens = 0
        try:
            async for item in engine.generate(ctx):
                if isinstance(item, Annotated):
                    if item.is_error:
                        status = 502 if not chunks else 500
                        writer.write(_error_bytes(status, item.error_message() or "engine error"))
                        return
                    if item.data is None:
                        continue
                    chunks.append(item.data)
                else:
                    chunks.append(item)
                if _chunk_has_content(chunks[-1]):
                    guard.mark_first_token()
                    n_tokens += 1
        except HttpError as e:
            writer.write(_error_bytes(e.status, e.message))
            return
        if not chunks:
            writer.write(_error_bytes(500, "engine produced no response"))
            return
        full = aggregate_chat_chunks(chunks) if chat else aggregate_completion_chunks(chunks)
        guard.mark_ok()
        guard.count_tokens(n_tokens)
        writer.write(_json_bytes(200, full))


# InflightGuard status label → edge-span terminal status (the recorder pins
# "error"; plain "success" maps to the span model's "ok")
_EDGE_STATUS = {"success": "ok", "overloaded": "overloaded", "error": "error"}


def _chunk_has_content(payload) -> bool:
    """True if this chunk carries generated content (a token), not just a
    role/finish frame: keeps output-token metrics and TTFT honest."""
    if not isinstance(payload, dict):
        return False
    for choice in payload.get("choices", []):
        if (choice.get("delta") or {}).get("content"):
            return True
        if choice.get("text"):
            return True
    return False


def _error_finish(envelope: Optional[dict], chat: bool) -> bytes:
    """A well-formed final chunk with ``finish_reason: "error"``."""
    chunk: dict = dict(envelope or {})
    choice: dict = {"index": 0, "finish_reason": "error"}
    if chat:
        choice["delta"] = {}
    else:
        choice["text"] = ""
    chunk["choices"] = [choice]
    return f"data: {json.dumps(chunk)}\n\n".encode()
