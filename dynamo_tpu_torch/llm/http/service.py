"""OpenAI-compatible HTTP frontend on ``asyncio.start_server``.

Routes: POST /v1/chat/completions, POST /v1/completions (streaming SSE and
unary), GET /v1/models, GET /health. HTTP/1.1 with one request per
connection (``Connection: close``); streamed responses use chunked transfer
encoding, one SSE frame per chunk. The engine is always called streaming;
unary requests fold the chunk stream through the aggregators. A client that
goes away kills the engine context.

Counterpart of the JAX package's ``llm/http/service.py`` (aiohttp) for the
routes above; its QoS, tracing, metrics and telemetry planes are not here.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from typing import Optional, Tuple

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
    """Parse one HTTP/1.1 request: (method, path, headers, body)."""
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
    return method.upper(), target.split("?", 1)[0], headers, body


def _head(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _json_bytes(status: int, payload) -> bytes:
    body = json.dumps(payload).encode()
    return _head(status, {
        "Content-Type": "application/json", "Content-Length": str(len(body)),
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
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> int:
        """Start serving; returns the bound port."""
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("HTTP service listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
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
                method, path, _headers, body = await _read_request(reader)
            except _BadRequest as e:
                writer.write(_error_bytes(e.status, str(e)))
                return
            except (ConnectionResetError, asyncio.IncompleteReadError):
                return
            await self._route(method, path, body, writer)
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

    async def _route(self, method: str, path: str, body: bytes, writer) -> None:
        if path in ("/v1/chat/completions", "/v1/completions"):
            if method != "POST":
                writer.write(_error_bytes(405, "use POST"))
                return
            await self._handle_openai(body, writer, chat=path.endswith("chat/completions"))
        elif path == "/v1/models" and method == "GET":
            writer.write(_json_bytes(200, model_list(self.manager.model_names())))
        elif path == "/health" and method == "GET":
            models = {n: {"status": "healthy"} for n in self.manager.model_names()}
            writer.write(_json_bytes(200, {"status": "healthy", "models": models}))
        else:
            writer.write(_error_bytes(404, f"no route {method} {path}"))

    async def _handle_openai(self, body: bytes, writer, chat: bool) -> None:
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
        if oai_req.stream:
            await self._stream_response(engine, ctx, writer, chat)
        else:
            await self._unary_response(engine, ctx, writer, chat)

    async def _stream_response(self, engine: AsyncEngine, ctx: Context, writer, chat: bool) -> None:
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
                writer.write(_chunk(f"data: {json.dumps(payload)}\n\n".encode()))
                await writer.drain()
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

    async def _unary_response(self, engine: AsyncEngine, ctx: Context, writer, chat: bool) -> None:
        chunks: list[dict] = []
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
        except HttpError as e:
            writer.write(_error_bytes(e.status, e.message))
            return
        if not chunks:
            writer.write(_error_bytes(500, "engine produced no response"))
            return
        full = aggregate_chat_chunks(chunks) if chat else aggregate_completion_chunks(chunks)
        writer.write(_json_bytes(200, full))


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
