"""Engine-agnostic internal request/response protocol.

The preprocessor lowers OpenAI requests into a :class:`PreprocessedRequest`
(token ids + stop conditions + sampling options); engines emit
:class:`LLMEngineOutput` items which the backend detokenizes into
:class:`BackendOutput`. Reference parity: lib/llm/src/protocols/common.rs:52-644,
common/llm_backend.rs:27-126, common/preprocessor.rs:25.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class HttpError(Exception):
    """An error with an HTTP status, raisable from any pipeline stage.

    The frontend maps it to a JSON error response (or an in-band SSE error
    event if headers were already sent). Reference parity: HttpError in
    lib/bindings/python (SURVEY.md §2.4).
    """

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class FinishReason(str, enum.Enum):
    EOS = "eos"
    LENGTH = "length"
    STOP = "stop"
    ERROR = "error"
    CANCELLED = "cancelled"

    def to_openai(self) -> str:
        if self is FinishReason.LENGTH:
            return "length"
        if self is FinishReason.ERROR:
            return "error"
        return "stop"


@dataclass
class StopConditions:
    """Reference: StopConditions (lib/llm/src/protocols/common.rs)."""

    max_tokens: Optional[int] = None
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    min_tokens: Optional[int] = None
    ignore_eos: bool = False


@dataclass
class SamplingOptions:
    """Reference: SamplingOptions (lib/llm/src/protocols/common.rs)."""

    n: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    seed: Optional[int] = None
    # None = no logprobs; 0 = chosen-token logprob only; k>0 = also the
    # top-k alternative tokens per step
    logprobs: Optional[int] = None


@dataclass
class PreprocessedRequest:
    """Token-level request handed to an engine (a.k.a. BackendInput).

    Reference: PreprocessedRequest / BackendInput
    (lib/llm/src/protocols/common/preprocessor.rs:25, common/llm_backend.rs).
    """

    token_ids: list[int]
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    eos_token_ids: list[int] = field(default_factory=list)
    annotations: list[str] = field(default_factory=list)
    mdc_sum: Optional[str] = None
    # mid-stream resume marker (runtime/resilience.StreamJournal): when the
    # routing client re-admits a broken stream as prompt+generated, this
    # carries {"prompt_len": where the ORIGINAL prompt ended inside
    # token_ids, "rng_offset": draws the original stream consumed}. Engines
    # rebuild sampling state (penalty counts over token_ids[prompt_len:])
    # from it; None (the wire default) is exactly the pre-resume request.
    resume: Optional[dict] = None
    # live-migration attach marker (disagg/migration.py): the staged
    # migration id a re-homed client presents to the target engine so
    # admission adopts the pre-shipped KV (zero recomputed positions)
    # instead of re-prefilling. None (the wire default) is exactly the
    # pre-migration request; an unknown/expired id degrades to the resume
    # recompute path.
    migrate: Optional[str] = None

    def to_dict(self) -> dict:
        from dataclasses import asdict

        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d["token_ids"]),
            stop_conditions=StopConditions(**d.get("stop_conditions", {})),
            sampling_options=SamplingOptions(**d.get("sampling_options", {})),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            annotations=list(d.get("annotations", [])),
            mdc_sum=d.get("mdc_sum"),
            resume=d.get("resume") if isinstance(d.get("resume"), dict) else None,
            migrate=(
                str(d["migrate"])
                if isinstance(d.get("migrate"), (str, int)) else None
            ),
        )


@dataclass
class LLMEngineOutput:
    """One streamed step from an engine: newly generated token ids.

    Reference: LLMEngineOutput (lib/llm/src/protocols/common/llm_backend.rs:27-126).
    `text` is optional engine-side detokenization used only for validation; the
    canonical text comes from the Backend decoder.
    """

    token_ids: list[int] = field(default_factory=list)
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    finish_reason: Optional[FinishReason] = None
    # per-token log-probabilities (parallel to token_ids) and, when the
    # request asked for alternatives, per-token {token_id: logprob} maps
    log_probs: Optional[list[float]] = None
    top_logprobs: Optional[list[dict[int, float]]] = None
    # engine-specific side data (e.g. kv hit-rate annotations)
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def final(cls, reason: FinishReason) -> "LLMEngineOutput":
        return cls(finish_reason=reason)

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"token_ids": self.token_ids}
        if self.text is not None:
            out["text"] = self.text
        if self.cum_log_probs is not None:
            out["cum_log_probs"] = self.cum_log_probs
        if self.finish_reason is not None:
            out["finish_reason"] = self.finish_reason.value
        if self.log_probs is not None:
            out["log_probs"] = self.log_probs
        if self.top_logprobs is not None:
            # JSON object keys are strings; from_dict restores ints
            out["top_logprobs"] = [
                {str(k): v for k, v in d.items()} for d in self.top_logprobs
            ]
        if self.extra:
            out["extra"] = self.extra
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "LLMEngineOutput":
        fr = d.get("finish_reason")
        top = d.get("top_logprobs")
        return cls(
            token_ids=list(d.get("token_ids", [])),
            text=d.get("text"),
            cum_log_probs=d.get("cum_log_probs"),
            finish_reason=FinishReason(fr) if fr else None,
            log_probs=d.get("log_probs"),
            top_logprobs=(
                [{int(k): v for k, v in t.items()} for t in top]
                if top is not None
                else None
            ),
            extra=dict(d.get("extra", {})),
        )


@dataclass
class BackendOutput:
    """Detokenized output leaving the Backend post-processor.

    Reference: BackendOutput (lib/llm/src/protocols/common/llm_backend.rs).
    """

    token_ids: list[int] = field(default_factory=list)
    text: Optional[str] = None
    finish_reason: Optional[FinishReason] = None
    cum_log_probs: Optional[float] = None
    log_probs: Optional[list[float]] = None
    top_logprobs: Optional[list[dict[int, float]]] = None
