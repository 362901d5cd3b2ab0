"""Composable request/response pipelines.

A pipeline is a chain of :class:`Operator` stages ending in an :class:`AsyncEngine`.
Requests flow forward through each operator (which may transform them); the
response stream flows backward through the same operators (which may transform
each item). Because a network client is itself an AsyncEngine, a pipeline can be
cut at any point and its tail served in another process — the frontend half ends
in the client engine, the backend half is served behind a network ingress.

Reference parity: dynamo's pipeline graph — `Source`/`Sink`/`Operator`,
`ServiceFrontend`, `SegmentSource/Sink`, `ServiceBackend`, `.link()`
(lib/runtime/src/pipeline/nodes.rs:48-351). This package collapses the
node/edge machinery into one functional composition: an operator receives the
request and the downstream engine and returns the (transformed) response stream.
"""

from __future__ import annotations

import abc
from typing import AsyncIterator, Generic, TypeVar

from .engine import AsyncEngine, Context

InReq = TypeVar("InReq")
OutReq = TypeVar("OutReq")
InResp = TypeVar("InResp")
OutResp = TypeVar("OutResp")


class Operator(abc.ABC, Generic[InReq, OutReq, InResp, OutResp]):
    """A bidirectional pipeline stage.

    ``generate`` receives the incoming request and the *downstream* engine. A
    typical implementation transforms the request, iterates the downstream
    stream, and yields transformed items. Reference: `Operator`/`PipelineOperator`
    (lib/runtime/src/pipeline/nodes.rs), e.g. the OpenAI preprocessor operator
    (lib/llm/src/preprocessor.rs:64-359).
    """

    @abc.abstractmethod
    def generate(
        self, request: Context[InReq], next_engine: AsyncEngine[OutReq, InResp]
    ) -> AsyncIterator[OutResp]:
        ...


class _OperatorEngine(AsyncEngine[InReq, OutResp]):
    """Binds an operator to its downstream engine, forming a new engine."""

    def __init__(self, op: Operator, next_engine: AsyncEngine):
        self._op = op
        self._next = next_engine

    def generate(self, request: Context[InReq]) -> AsyncIterator[OutResp]:
        return self._op.generate(request, self._next)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self._op).__name__}→{self._next!r}"


class PipelineBuilder(Generic[InReq]):
    """Fluent `.link()` builder, mirroring the reference's segment linking.

    Usage::

        engine = (
            Pipeline()
            .link(OpenAIPreprocessorOperator(card))
            .link(DetokenizeOperator(card))
            .link_engine(jax_engine)
        )
    """

    def __init__(self) -> None:
        self._ops: list[Operator] = []

    def link(self, op: Operator) -> "PipelineBuilder":
        self._ops.append(op)
        return self

    def link_engine(self, engine: AsyncEngine) -> AsyncEngine:
        for op in reversed(self._ops):
            engine = _OperatorEngine(op, engine)
        return engine


def Pipeline() -> PipelineBuilder:
    return PipelineBuilder()

