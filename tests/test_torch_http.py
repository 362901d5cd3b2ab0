"""``in=http out=torch --device cpu`` end to end on the fixture model: a
streaming chat and a streaming completion over HTTP. The SSE text equals the
detokenized greedy tokens of the port's engine for the same prompt, and the
chunks carry the same fields and finish_reason as the JAX package's frontend
(``out=jax``'s preprocessor/detokenizer pipeline and aiohttp service) puts on
the wire for the same token stream. Token equality with the JAX engine is
held at engine level in fp32 (test_torch_engine.py): this path runs bf16."""

import asyncio
import http.client
import json
import threading

import pytest

from dynamo_tpu.cli.run import _token_pipelines as jax_token_pipelines
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.llm.http.service import ModelManager as JaxModelManager
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.runtime.annotated import Annotated as JaxAnnotated
from dynamo_tpu_torch.cli.run import build_engine, build_parser, make_service
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest, CompletionRequest
from dynamo_tpu_torch.llm.tokenizer import DecodeStream
from dynamo_tpu_torch.runtime.engine import Context

MAX_TOKENS = 8


class _Served:
    """An asyncio server (started by ``start()``) on its own loop thread."""

    def __init__(self, service):
        self.loop = asyncio.new_event_loop()
        self.service = service
        ready = threading.Event()
        self.port = None

        async def main():
            self.port = await service.start()
            ready.set()

        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(main(), self.loop).result(30)
        assert ready.is_set()

    def close(self):
        asyncio.run_coroutine_threadsafe(self.service.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


class _JaxWire:
    """Feeds the JAX frontend's pipeline from the port's core engine (the
    token stream both frontends turn into chunks)."""

    def __init__(self, core):
        self.core = core

    async def generate(self, request):
        async for item in self.core.generate(request.transfer(request.data.to_dict())):
            yield JaxAnnotated.from_dict(item.to_dict())


def _sse(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    raw = resp.read().decode()
    conn.close()
    frames = [f[len("data: "):] for f in raw.split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    return [json.loads(f) for f in frames[:-1]]


def _shape(chunk):
    return (sorted(chunk), [
        (sorted(c), sorted(c.get("delta", {})), c.get("finish_reason")) for c in chunk["choices"]
    ], sorted(chunk.get("usage") or {}))


@pytest.fixture(scope="module")
def served(model_dir):
    flags = build_parser().parse_args(
        ["--model-path", model_dir, "--device", "cpu", "--host", "127.0.0.1", "--port", "0"]
    )
    chat, comp, name, core = build_engine("torch", flags)
    port_srv = _Served(make_service(chat, comp, name, flags))
    jchat, jcomp = jax_token_pipelines(JaxCard.from_local_path(model_dir), lambda: _JaxWire(core))
    manager = JaxModelManager()
    manager.add_chat_model(name, jchat)
    manager.add_completions_model(name, jcomp)
    jax_srv = _Served(JaxHttpService(manager, host="127.0.0.1", port=0))
    yield name, core, model_dir, port_srv.port, jax_srv.port
    port_srv.close()
    jax_srv.close()
    core.close()


def _engine_text(core, tokenizer, token_ids):
    async def go():
        req = PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=StopConditions(max_tokens=MAX_TOKENS, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0),
        )
        out = []
        async for item in core.generate(Context(req)):
            out.extend((item.data or {}).get("token_ids", []))
        return out

    toks = asyncio.run(go())
    stream = DecodeStream(tokenizer)
    return "".join(filter(None, (stream.step(t) for t in toks)))


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/v1/completions"])
def test_stream_matches_engine_and_jax_frontend(served, path):
    name, core, model_dir, port, jax_port = served
    chat = path.endswith("chat/completions")
    body = {"model": name, "stream": True, "max_tokens": MAX_TOKENS,
            "nvext": {"ignore_eos": True}, "stream_options": {"include_usage": True}}
    if chat:
        body["messages"] = [{"role": "user", "content": "hello world"}]
    else:
        body["prompt"] = "the quick brown"
    chunks = _sse(port, path, body)
    jax_chunks = _sse(jax_port, path, body)

    pre = OpenAIPreprocessor(ModelDeploymentCard.from_local_path(model_dir))
    lowered = (pre.preprocess_chat(ChatCompletionRequest.from_dict(body)) if chat
               else pre.preprocess_completion(CompletionRequest.from_dict(body)))
    assert len(lowered.token_ids) < core.config.kv_block_size  # no prefix-cache hits
    want = _engine_text(core, pre.tokenizer, lowered.token_ids)

    def text(cs):
        return "".join((c["choices"][0].get("delta") or {}).get("content") or
                       c["choices"][0].get("text") or "" for c in cs)

    assert text(chunks) == want == text(jax_chunks)
    assert [_shape(c) for c in chunks] == [_shape(c) for c in jax_chunks]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == MAX_TOKENS
    assert {c["object"] for c in chunks} == {"chat.completion.chunk" if chat else "text_completion"}


def test_unary_models_health_and_errors(served):
    name, _, _, port, _ = served

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request(method, path, None if body is None else json.dumps(body))
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read() or b"null")
        conn.close()
        return out

    st, full = call("POST", "/v1/completions", {"model": name, "prompt": "hi", "max_tokens": 3})
    assert st == 200 and full["choices"][0]["finish_reason"] in ("length", "stop")
    assert call("GET", "/v1/models")[1]["data"][0]["id"] == name
    assert call("GET", "/health") == (200, {"status": "healthy", "models": {name: {"status": "healthy"}}})
    assert call("POST", "/v1/completions", {"model": "nope", "prompt": "x"})[0] == 404
    assert call("POST", "/v1/chat/completions", {"model": name, "messages": "x"})[0] == 400
    assert call("GET", "/nowhere")[0] == 404
