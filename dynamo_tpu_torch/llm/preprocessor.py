"""OpenAI preprocessor: chat-template rendering + tokenization, and the
detokenizer on the response path.

Counterpart of the JAX package's ``llm/preprocessor.py``, with its
detokenize CPU attribution (the profiling plane, ``DYN_TPU_PROFILE``).
Chat templates are rendered with jinja2
against the HF ``chat_template`` from tokenizer_config.json, with the helper
environment HF uses (``raise_exception``, ``tojson``, ``strftime_now``).
"""

from __future__ import annotations

import asyncio
import datetime
import json
import logging
import time
from dataclasses import replace
from typing import AsyncIterator, Optional, Union

import jinja2

from ..engine_torch.sampling import CANDIDATES as SAMPLING_CANDIDATES
from ..runtime import profiling, tracing
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, Context
from ..runtime.pipeline import Operator
from .model_card import ModelDeploymentCard
from .protocols.common import (
    BackendOutput,
    FinishReason,
    HttpError,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from .protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    DeltaGenerator,
    message_text,
    new_request_id,
    usage_dict,
)
from .tokenizer import HFTokenizer, StopSequenceDecoder

logger = logging.getLogger(__name__)

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


def _raise_exception(message: str):
    raise jinja2.TemplateError(message)


def _tojson(value, indent=None):
    return json.dumps(value, indent=indent)


def _strftime_now(fmt: str) -> str:
    return datetime.datetime.now().strftime(fmt)


class PromptFormatter:
    """Renders chat messages into a prompt string via the model's chat template."""

    def __init__(self, card: ModelDeploymentCard):
        if not card.chat_template:
            raise ValueError(f"model {card.display_name!r} has no chat template")
        env = jinja2.Environment(
            loader=jinja2.BaseLoader(),
            trim_blocks=True,
            lstrip_blocks=True,
            extensions=["jinja2.ext.loopcontrols"],
        )
        env.globals["raise_exception"] = _raise_exception
        env.globals["strftime_now"] = _strftime_now
        env.filters["tojson"] = _tojson
        self._template = env.from_string(card.chat_template)
        self._card = card

    def render(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: Optional[list[dict]] = None,
    ) -> str:
        return self._template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self._card.bos_token or "",
            eos_token=self._card.eos_token or "",
            tools=tools,
        )


class OpenAIPreprocessor:
    """Stateless request lowering: OpenAI request → PreprocessedRequest."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Optional[HFTokenizer] = None):
        self.card = card
        if tokenizer is None:
            if not card.tokenizer_file:
                raise ValueError(
                    f"model {card.display_name!r} has no tokenizer.json "
                    f"(searched {card.model_path!r})"
                )
            tokenizer = HFTokenizer.from_file(card.tokenizer_file)
        self.tokenizer = tokenizer
        self.formatter = PromptFormatter(card) if card.chat_template else None

    def preprocess_chat(self, request: ChatCompletionRequest) -> PreprocessedRequest:
        if self.formatter is None:
            raise ValueError("chat requests require a chat template")
        raw = request.nvext.use_raw_prompt if request.nvext else False
        if raw and request.messages:
            prompt = message_text(request.messages[-1])
        else:
            tools = request.tools if request.tool_choice != "none" else None
            prompt = self.formatter.render(request.messages, tools=tools)
        token_ids = self.tokenizer.encode(prompt)
        return self._build(request, prompt, token_ids, request.stop_list())

    def preprocess_completion(self, request: CompletionRequest) -> PreprocessedRequest:
        if request.suffix:
            raise HttpError(
                400, "suffix (fill-in-the-middle) is not supported by this model"
            )
        prompt = request.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = [int(t) for t in prompt]
            prompt_text = self.tokenizer.decode(token_ids) if request.echo else None
        else:
            if isinstance(prompt, list):
                prompt = "".join(prompt)
            prompt_text = str(prompt)
            token_ids = self.tokenizer.encode(prompt_text)
        return self._build(request, prompt_text, token_ids, request.stop_list())

    def _build(
        self,
        request: Union[ChatCompletionRequest, CompletionRequest],
        prompt: Optional[str],
        token_ids: list[int],
        stops: list[str],
    ) -> PreprocessedRequest:
        ignore_eos = bool(request.nvext.ignore_eos) if request.nvext else False
        max_tokens = (
            request.effective_max_tokens()
            if isinstance(request, ChatCompletionRequest)
            else request.max_tokens
        )
        budget = self.card.context_length - len(token_ids)
        if budget <= 0:
            raise HttpError(
                400,
                f"prompt is {len(token_ids)} tokens but the model context window "
                f"is {self.card.context_length}",
            )
        max_tokens = budget if max_tokens is None else min(max_tokens, budget)
        for name in ("frequency_penalty", "presence_penalty"):
            val = getattr(request, name, None)
            if val is not None and not -2.0 <= val <= 2.0:
                raise HttpError(400, f"{name} must be within [-2, 2], got {val}")
        top_k = request.top_k
        if top_k is not None and top_k > SAMPLING_CANDIDATES:
            logger.debug(
                "top_k=%d exceeds the sampler's candidate budget %d; clamping",
                top_k, SAMPLING_CANDIDATES,
            )
            top_k = SAMPLING_CANDIDATES
        pre = PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=StopConditions(
                max_tokens=max_tokens,
                stop=stops,
                ignore_eos=ignore_eos,
                min_tokens=getattr(request, "min_tokens", None),
            ),
            sampling_options=SamplingOptions(
                n=request.n,
                temperature=request.temperature,
                top_p=request.top_p,
                top_k=top_k,
                frequency_penalty=request.frequency_penalty,
                presence_penalty=request.presence_penalty,
                seed=request.seed,
                logprobs=_logprobs_request(request),
            ),
            eos_token_ids=list(self.card.eos_token_ids),
            annotations=list((request.nvext.annotations if request.nvext else None) or []),
            mdc_sum=self.card.mdcsum,
        )
        if prompt is not None:
            pre._formatted_prompt = prompt  # carried for annotations only
        return pre


def _logprobs_request(request) -> Optional[int]:
    """OpenAI request fields → engine logprobs ask (None = off)."""
    lp = getattr(request, "logprobs", None)
    if lp is None or lp is False:
        return None
    if lp is True:
        asked = int(getattr(request, "top_logprobs", None) or 0)
    else:
        asked = int(lp)
    if not 0 <= asked <= 20:
        raise HttpError(400, f"top_logprobs must be within [0, 20], got {asked}")
    return asked


class ChatPreprocessorOperator(Operator):
    """Pipeline stage: OpenAI request → tokens forward, chunk dicts backward."""

    def __init__(self, preprocessor: OpenAIPreprocessor, chat: bool = True):
        self._pre = preprocessor
        self._chat = chat

    def _format_logprobs(self, out: BackendOutput) -> Optional[dict]:
        if out.log_probs is None:
            return None
        decode = self._pre.tokenizer.decode
        tokens = out.token_ids[: len(out.log_probs)]
        if self._chat:
            entries = []
            for i, (tid, lp) in enumerate(zip(tokens, out.log_probs)):
                entry = {"token": decode([tid]), "logprob": lp}
                if out.top_logprobs is not None and i < len(out.top_logprobs):
                    entry["top_logprobs"] = [
                        {"token": decode([t]), "logprob": l}
                        for t, l in out.top_logprobs[i].items()
                    ]
                entries.append(entry)
            return {"content": entries} if entries else None
        if not tokens:
            return None
        return {
            "tokens": [decode([t]) for t in tokens],
            "token_logprobs": list(out.log_probs[: len(tokens)]),
            "top_logprobs": [
                (
                    {decode([t]): l for t, l in out.top_logprobs[i].items()}
                    if out.top_logprobs is not None and i < len(out.top_logprobs)
                    else {}
                )
                for i in range(len(tokens))
            ],
        }

    async def generate(
        self, request: Context[Union[ChatCompletionRequest, CompletionRequest]],
        next_engine: AsyncEngine,
    ) -> AsyncIterator[Annotated[dict]]:
        oai_req = request.data
        if self._chat:
            pre = self._pre.preprocess_chat(oai_req)
        else:
            pre = self._pre.preprocess_completion(oai_req)

        if ANNOTATION_FORMATTED_PROMPT in pre.annotations and getattr(pre, "_formatted_prompt", None):
            yield Annotated.from_annotation(ANNOTATION_FORMATTED_PROMPT, pre._formatted_prompt)
        if ANNOTATION_TOKEN_IDS in pre.annotations:
            yield Annotated.from_annotation(ANNOTATION_TOKEN_IDS, pre.token_ids)

        request_id = new_request_id("chatcmpl" if self._chat else "cmpl")
        gen = DeltaGenerator(request_id, oai_req.model, chat=self._chat)
        prompt_tokens = len(pre.token_ids)
        completion_tokens = 0
        include_usage = bool(
            oai_req.stream_options and oai_req.stream_options.include_usage
        )
        echo = bool(not self._chat and getattr(oai_req, "echo", None))
        n = oai_req.n or 1
        if not 1 <= n <= 32:
            raise HttpError(400, f"n must be within [1, 32], got {n}")

        # n>1: n engine streams (seed-varied), multiplexed by choice index
        queue: asyncio.Queue = asyncio.Queue(maxsize=16)
        _DONE = object()

        def choice_request(i: int) -> PreprocessedRequest:
            if n == 1:
                return pre
            so = replace(
                pre.sampling_options,
                seed=(pre.sampling_options.seed or 0) + i if i else pre.sampling_options.seed,
            )
            return replace(pre, sampling_options=so)

        if n == 1:
            child_ctxs = [request.transfer(pre)]
            prop_task = None
        else:
            child_ctxs = [Context(choice_request(i)) for i in range(n)]

            async def propagate_cancel():
                await request.context.stopped()
                for c in child_ctxs:
                    c.context.stop_generating()

            prop_task = asyncio.create_task(propagate_cancel())

        async def pump(i: int):
            try:
                try:
                    async for item in next_engine.generate(child_ctxs[i]):
                        await queue.put((i, item))
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    await queue.put((i, ("__raise__", e)))
            finally:
                await queue.put((i, _DONE))

        tasks = [asyncio.create_task(pump(i)) for i in range(n)]
        echoed = [not echo] * n
        finished = 0
        finish_count = 0
        try:
            while finished < n:
                idx, item = await queue.get()
                if item is _DONE:
                    finished += 1
                    continue
                if isinstance(item, tuple) and item and item[0] == "__raise__":
                    raise item[1]
                if isinstance(item, Annotated):
                    if item.is_error:
                        yield item
                        return
                    if item.data is None:
                        if idx == 0:
                            yield item
                        continue
                    out = item.data
                else:
                    out = item
                if not isinstance(out, BackendOutput):
                    raise TypeError(f"expected BackendOutput, got {type(out).__name__}")

                completion_tokens += len(out.token_ids)
                text = out.text or ""
                if not echoed[idx]:
                    echoed[idx] = True
                    text = (getattr(pre, "_formatted_prompt", None) or "") + text
                if text:
                    chunk = gen.text_chunk(
                        text, index=idx, logprobs=self._format_logprobs(out)
                    )
                    yield Annotated.from_data(chunk, id=request.id)
                if out.finish_reason is not None:
                    finish_count += 1
                    usage = (
                        usage_dict(prompt_tokens, completion_tokens)
                        if include_usage and finish_count == n
                        else None
                    )
                    chunk = gen.finish_chunk(out.finish_reason, index=idx, usage=usage)
                    yield Annotated.from_data(chunk, id=request.id)
        finally:
            if prop_task is not None:
                prop_task.cancel()
            for t in tasks:
                t.cancel()


class DetokenizeOperator(Operator):
    """Pipeline stage: engine token-id stream → detokenized BackendOutput
    stream, holding the per-request stop-sequence jail."""

    def __init__(self, card: ModelDeploymentCard, tokenizer: Optional[HFTokenizer] = None):
        self.card = card
        self.tokenizer = tokenizer or HFTokenizer.from_file(card.tokenizer_file)
        # per-token CPU of incremental detokenization (profiling plane).
        # None with DYN_TPU_PROFILE off: one None-check per stream item
        self._fcpu = profiling.frontend_cpu() if profiling.enabled() else None

    async def generate(
        self, request: Context[PreprocessedRequest], next_engine: AsyncEngine
    ) -> AsyncIterator[Annotated[BackendOutput]]:
        pre = request.data
        stop_ids = set(pre.stop_conditions.stop_token_ids)
        if not pre.stop_conditions.ignore_eos:
            stop_ids.update(pre.eos_token_ids)
        decoder = StopSequenceDecoder(
            self.tokenizer, stop_sequences=list(pre.stop_conditions.stop),
            stop_token_ids=list(stop_ids),
        )

        emitted = 0
        async for item in next_engine.generate(request):
            ann_id = item.id if isinstance(item, Annotated) else request.id
            if isinstance(item, Annotated):
                if item.is_error:
                    yield item
                    return
                if item.data is None:
                    yield item
                    continue
                out = LLMEngineOutput.from_dict(item.data) if isinstance(item.data, dict) else item.data
            else:
                out = item

            text_parts: list[str] = []
            finish: Optional[FinishReason] = out.finish_reason
            stop_hit = False
            kept_tokens: list[int] = []
            t_detok = time.perf_counter() if self._fcpu is not None else 0.0
            for tok in out.token_ids:
                decision = decoder.step(tok)
                if decision.text:
                    text_parts.append(decision.text)
                if not decision.stopped or decision.stop_token:
                    kept_tokens.append(tok)
                if decision.stopped:
                    finish = FinishReason.STOP if not decision.stop_token else FinishReason.EOS
                    stop_hit = True
                    break
            if self._fcpu is not None and out.token_ids:
                dt = time.perf_counter() - t_detok
                self._fcpu.note("detokenize", dt * 1e6, tokens=len(out.token_ids))
                if tracing.enabled():
                    tracing.observe_phase("detokenize", dt)
            emitted += len(kept_tokens)

            max_t = pre.stop_conditions.max_tokens
            if finish is None and max_t is not None and emitted >= max_t:
                finish = FinishReason.LENGTH

            if finish is not None and not stop_hit:
                tail = decoder.flush()
                if tail:
                    text_parts.append(tail)

            kept = len(kept_tokens)
            yield Annotated.from_data(
                BackendOutput(
                    token_ids=kept_tokens,
                    text="".join(text_parts) or None,
                    finish_reason=finish,
                    cum_log_probs=out.cum_log_probs,
                    log_probs=(
                        out.log_probs[:kept] if out.log_probs is not None else None
                    ),
                    top_logprobs=(
                        out.top_logprobs[:kept]
                        if out.top_logprobs is not None
                        else None
                    ),
                ),
                id=ann_id,
            )
            if finish is not None:
                if out.finish_reason is None:
                    # finished before the engine did (stop string / max_tokens):
                    # release its slot now
                    request.context.stop_generating()
                return
