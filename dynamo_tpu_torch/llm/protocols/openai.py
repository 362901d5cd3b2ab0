"""OpenAI-compatible protocol types: chat completions and completions.

Requests are stdlib dataclasses built by ``from_dict``, which checks the type
of every field the serving path reads and raises ``ValueError`` (the HTTP
edge answers 400); unknown fields are accepted and ignored, as OpenAI's
clients expect. Stream chunks and responses are plain dicts with exactly the
keys the JAX package's pydantic models dump (``exclude_none``), so the two
frontends put the same fields on the wire. The ``nvext`` extension block
keeps the reference's names.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional, Union

from .common import FinishReason

_MISSING = object()


def _get(d: dict, name: str, kinds, default=None, required: bool = False):
    """d[name] checked against ``kinds`` (bool is never taken for a number)."""
    val = d.get(name, _MISSING)
    if val is _MISSING or val is None:
        if required:
            raise ValueError(f"{name}: field required")
        return default
    if isinstance(val, bool) and bool not in kinds:
        raise ValueError(f"{name}: expected {_names(kinds)}, got bool")
    if not isinstance(val, kinds):
        raise ValueError(f"{name}: expected {_names(kinds)}, got {type(val).__name__}")
    if float in kinds and isinstance(val, int):
        val = float(val)
    return val


def _names(kinds) -> str:
    return "/".join(k.__name__ for k in kinds)


@dataclass
class NvExt:
    """NVIDIA-compatible extension block (reference: nvext.rs:193)."""

    ignore_eos: Optional[bool] = None
    annotations: Optional[list[str]] = None
    use_raw_prompt: Optional[bool] = None

    @classmethod
    def from_dict(cls, d: Any) -> "NvExt":
        if not isinstance(d, dict):
            raise ValueError("nvext: expected an object")
        ann = _get(d, "annotations", (list,))
        if ann is not None and not all(isinstance(a, str) for a in ann):
            raise ValueError("nvext.annotations: expected a list of strings")
        return cls(
            ignore_eos=_get(d, "ignore_eos", (bool,)),
            annotations=ann,
            use_raw_prompt=_get(d, "use_raw_prompt", (bool,)),
        )


@dataclass
class StreamOptions:
    include_usage: Optional[bool] = None


def _stream_options(d: dict) -> Optional[StreamOptions]:
    so = _get(d, "stream_options", (dict,))
    return None if so is None else StreamOptions(_get(so, "include_usage", (bool,)))


def _stop(d: dict) -> Optional[Union[str, list[str]]]:
    stop = _get(d, "stop", (str, list))
    if isinstance(stop, list) and not all(isinstance(s, str) for s in stop):
        raise ValueError("stop: expected a string or a list of strings")
    return stop


def _nvext(d: dict) -> Optional[NvExt]:
    raw = d.get("nvext")
    return None if raw is None else NvExt.from_dict(raw)


def message_text(msg: dict) -> str:
    content = msg.get("content")
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(
            part.get("text", "") for part in content
            if isinstance(part, dict) and part.get("type") == "text"
        )
    return ""


@dataclass
class _Common:
    model: str
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: Optional[int] = None
    stop: Optional[Union[str, list[str]]] = None
    seed: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    nvext: Optional[NvExt] = None

    @staticmethod
    def _common(d: dict) -> dict:
        if not isinstance(d, dict):
            raise ValueError("request body must be a JSON object")
        return dict(
            model=_get(d, "model", (str,), required=True),
            stream=_get(d, "stream", (bool,), False),
            stream_options=_stream_options(d),
            max_tokens=_get(d, "max_tokens", (int,)),
            temperature=_get(d, "temperature", (int, float)),
            top_p=_get(d, "top_p", (int, float)),
            top_k=_get(d, "top_k", (int,)),
            n=_get(d, "n", (int,)),
            stop=_stop(d),
            seed=_get(d, "seed", (int,)),
            frequency_penalty=_get(d, "frequency_penalty", (int, float)),
            presence_penalty=_get(d, "presence_penalty", (int, float)),
            nvext=_nvext(d),
        )

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


@dataclass
class ChatCompletionRequest(_Common):
    messages: list[dict] = field(default_factory=list)
    max_completion_tokens: Optional[int] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    min_tokens: Optional[int] = None
    tools: Optional[list[dict]] = None
    tool_choice: Optional[Union[str, dict]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionRequest":
        common = cls._common(d)
        messages = _get(d, "messages", (list,), required=True)
        out = []
        for i, m in enumerate(messages):
            if not isinstance(m, dict):
                raise ValueError(f"messages[{i}]: expected an object")
            _get(m, "role", (str,), required=True)
            content = m.get("content")
            if content is not None and not isinstance(content, (str, list)):
                raise ValueError(f"messages[{i}].content: expected a string or a list")
            out.append({k: v for k, v in m.items() if v is not None})
        return cls(
            messages=out,
            max_completion_tokens=_get(d, "max_completion_tokens", (int,)),
            logprobs=_get(d, "logprobs", (bool,)),
            top_logprobs=_get(d, "top_logprobs", (int,)),
            min_tokens=_get(d, "min_tokens", (int,)),
            tools=_get(d, "tools", (list,)),
            tool_choice=_get(d, "tool_choice", (str, dict)),
            **common,
        )

    def effective_max_tokens(self) -> Optional[int]:
        return self.max_completion_tokens or self.max_tokens


@dataclass
class CompletionRequest(_Common):
    prompt: Union[str, list] = ""
    echo: Optional[bool] = None
    logprobs: Optional[int] = None  # number of alternatives per token
    suffix: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionRequest":
        common = cls._common(d)
        prompt = _get(d, "prompt", (str, list), required=True)
        if isinstance(prompt, list):
            ok = (
                all(isinstance(p, str) for p in prompt)
                or all(isinstance(p, int) and not isinstance(p, bool) for p in prompt)
            )
            if not ok:
                raise ValueError("prompt: expected a string, strings, or token ids")
        return cls(
            prompt=prompt,
            echo=_get(d, "echo", (bool,)),
            logprobs=_get(d, "logprobs", (int,)),
            suffix=_get(d, "suffix", (str,)),
            **common,
        )


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def model_list(names: list[str]) -> dict:
    now = int(time.time())
    return {
        "object": "list",
        "data": [
            {"id": n, "object": "model", "created": now, "owned_by": "dynamo_tpu"}
            for n in names
        ],
    }


class DeltaGenerator:
    """Builds OpenAI chunk dicts from detokenized backend text deltas."""

    def __init__(self, request_id: str, model: str, chat: bool = True):
        self.request_id = request_id
        self.model = model
        self.chat = chat
        self.created = int(time.time())
        self._started: set[int] = set()  # choice indexes that got their role

    def _envelope(self, choice: dict, usage: Optional[dict] = None) -> dict:
        out = {
            "id": self.request_id,
            "object": "chat.completion.chunk" if self.chat else "text_completion",
            "created": self.created,
            "model": self.model,
            "choices": [choice],
        }
        if usage is not None:
            out["usage"] = usage
        return out

    def text_chunk(self, text: str, index: int = 0, logprobs: Optional[dict] = None) -> dict:
        if self.chat:
            delta: dict = {}
            if index not in self._started:
                delta["role"] = "assistant"
                self._started.add(index)
            delta["content"] = text
            choice = {"index": index, "delta": delta}
        else:
            choice = {"index": index, "text": text}
        if logprobs is not None:
            choice["logprobs"] = logprobs
        return self._envelope(choice)

    def finish_chunk(self, reason: FinishReason, index: int = 0,
                     usage: Optional[dict] = None) -> dict:
        fr = reason.to_openai()
        if self.chat:
            choice = {"index": index, "delta": {}, "finish_reason": fr}
        else:
            choice = {"index": index, "text": "", "finish_reason": fr}
        return self._envelope(choice, usage)


def aggregate_chat_chunks(chunks: list[dict]) -> dict:
    """Fold a chunk stream into one chat.completion response dict."""
    if not chunks:
        raise ValueError("empty chunk stream")
    by_index: dict[int, dict] = {}
    usage = None
    for chunk in chunks:
        if chunk.get("usage") is not None:
            usage = chunk["usage"]
        for ch in chunk.get("choices", []):
            agg = by_index.setdefault(ch["index"], {
                "index": ch["index"],
                "message": {"role": "assistant", "content": ""},
            })
            delta = ch.get("delta") or {}
            if delta.get("role"):
                agg["message"]["role"] = delta["role"]
            if delta.get("content"):
                agg["message"]["content"] += delta["content"]
            lp = ch.get("logprobs")
            if lp and lp.get("content"):
                agg.setdefault("logprobs", {"content": []})["content"].extend(lp["content"])
            if ch.get("finish_reason"):
                agg["finish_reason"] = ch["finish_reason"]
    first = chunks[0]
    out = {
        "id": first["id"], "object": "chat.completion", "created": first["created"],
        "model": first["model"], "choices": [by_index[i] for i in sorted(by_index)],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def aggregate_completion_chunks(chunks: list[dict]) -> dict:
    """Fold a chunk stream into one text_completion response dict."""
    if not chunks:
        raise ValueError("empty chunk stream")
    by_index: dict[int, dict] = {}
    usage = None
    for chunk in chunks:
        if chunk.get("usage") is not None:
            usage = chunk["usage"]
        for ch in chunk.get("choices", []):
            agg = by_index.setdefault(ch["index"], {"index": ch["index"], "text": ""})
            agg["text"] += ch.get("text", "")
            lp = ch.get("logprobs")
            if lp:
                dst = agg.setdefault(
                    "logprobs", {"tokens": [], "token_logprobs": [], "top_logprobs": []}
                )
                for key in ("tokens", "token_logprobs", "top_logprobs"):
                    dst[key].extend(lp.get(key, []))
            if ch.get("finish_reason"):
                agg["finish_reason"] = ch["finish_reason"]
    first = chunks[0]
    out = {
        "id": first["id"], "object": "text_completion", "created": first["created"],
        "model": first["model"], "choices": [by_index[i] for i in sorted(by_index)],
    }
    if usage is not None:
        out["usage"] = usage
    return out
