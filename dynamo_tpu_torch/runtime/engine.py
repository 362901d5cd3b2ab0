"""The core streaming-engine abstraction.

An *engine* turns one request into an async stream of responses. Everything in the
framework — models, preprocessors, routers, network clients — implements this one
interface, so pipelines compose uniformly in-process and across the network.

Reference parity: dynamo's `AsyncEngine` trait and `AsyncEngineContext`
(lib/runtime/src/engine.rs:47-116). This package expresses it with Python asyncio:
an engine is any object with ``async generate(request: Context) -> AsyncIterator``;
cancellation propagates through the shared :class:`Context` rather than a token tree.
"""

from __future__ import annotations

import abc
import asyncio
import uuid
from typing import AsyncIterator, Callable, Generic, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class EngineContext:
    """Cancellation + identity for one in-flight request.

    Mirrors the reference's AsyncEngineContext (lib/runtime/src/engine.rs:47-86):
    - ``id``       stable request id, propagated across process hops
    - ``stop()``   graceful: the engine should finish the current item and stop
    - ``kill()``   immediate: abandon the stream
    - ``trace``    tracing parent for this request (``runtime/tracing.py``):
      a local Span, a ``(trace_id, span_id)`` wire context extracted from a
      ``traceparent`` header, or None. Riding the context (rather than a
      contextvar) survives engine-thread hops and async-generator plumbing.
    - ``tenant``   QoS tenant id (``runtime/qos.py``), extracted at the
      HTTP edge (``x-tenant-id`` / API-key map) or from the RPC header;
      None on the single-tenant path. Rides the context so admission,
      scheduling, KV budgets, and tracing all attribute to the same id.
    - ``journal``  mid-stream resume journal
      (``runtime/resilience.StreamJournal``), attached by the routing
      client for token-level requests when resume is enabled; None
      otherwise (the zero-overhead off path). The HTTP edge reads its
      ``resumes`` count to attribute a post-resume first chunk as an ITL
      gap instead of admission TTFT.
    """

    __slots__ = ("_id", "_stopped", "_killed", "_stop_event", "trace",
                 "tenant", "journal")

    def __init__(self, request_id: Optional[str] = None):
        self._id = request_id or uuid.uuid4().hex
        self._stopped = False
        self._killed = False
        self._stop_event: Optional[asyncio.Event] = None
        self.trace = None
        self.tenant: Optional[str] = None
        self.journal = None

    @property
    def id(self) -> str:
        return self._id

    def stop_generating(self) -> None:
        self._stopped = True
        if self._stop_event is not None:
            self._stop_event.set()

    def kill(self) -> None:
        self._killed = True
        self._stopped = True
        if self._stop_event is not None:
            self._stop_event.set()

    @property
    def is_stopped(self) -> bool:
        return self._stopped

    @property
    def is_killed(self) -> bool:
        return self._killed

    async def stopped(self) -> None:
        """Await until stop/kill is requested."""
        if self._stopped:
            return
        if self._stop_event is None:
            self._stop_event = asyncio.Event()
        await self._stop_event.wait()


class Context(Generic[T]):
    """A request plus its engine context, flowing through a pipeline.

    Reference: `Context<T>` (lib/runtime/src/pipeline/context.rs). ``map`` rewraps
    the payload keeping the same context; ``transfer`` moves the context onto a new
    payload (used when an operator fully replaces the request).
    """

    __slots__ = ("data", "_ctx")

    def __init__(self, data: T, ctx: Optional[EngineContext] = None, request_id: Optional[str] = None):
        self.data = data
        self._ctx = ctx or EngineContext(request_id)

    @property
    def id(self) -> str:
        return self._ctx.id

    @property
    def context(self) -> EngineContext:
        return self._ctx

    def map(self, fn: Callable[[T], U]) -> "Context[U]":
        return Context(fn(self.data), ctx=self._ctx)

    def transfer(self, data: U) -> "Context[U]":
        return Context(data, ctx=self._ctx)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Context(id={self.id!r}, data={type(self.data).__name__})"


class AsyncEngine(abc.ABC, Generic[T, U]):
    """Engine interface: one request in, an async stream of responses out."""

    @abc.abstractmethod
    def generate(self, request: Context[T]) -> AsyncIterator[U]:
        """Return an async iterator of responses for this request.

        Implementations are normally ``async def generate(...)`` generator
        functions; callers iterate with ``async for``. Implementations must
        observe ``request.context.is_stopped`` between items.
        """
