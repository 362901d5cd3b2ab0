"""Launcher: ``python -m dynamo_tpu_torch.cli.run in=http out=torch --model-path DIR``.

Serves the model in ``DIR`` (an HF-layout directory: config.json,
tokenizer.json, tokenizer_config.json, and its weights as ``*.safetensors``
files) or in a single ``.gguf`` file through the OpenAI HTTP frontend and
the torch engine. The engine runs on CUDA unless ``--device cpu`` is given;
without a card and without ``--device cpu`` it raises. A directory without
weight files gets random weights (``--seed``). ``--host-cache-blocks N``
keeps up to N evicted KV blocks in host RAM for later prefix hits; the KV
page dtype is ``DYN_TPU_KV_DTYPE`` (``int8`` for int8 pages), as in the
JAX launcher. ``--tensor-parallel-size N`` serves over a tp mesh of N ranks
on ``cuda:0 … cuda:N-1`` (with ``--device cpu``, N ranks on the CPU).
``--quantize int8`` decodes from int8 weights and prefills from bf16 ones;
``--quantize int8-all`` keeps only int8 weights, quantized as they are read
or drawn (how llama3-70b or mixtral-8x7b fits one H100), on a mesh too.

Counterpart of the JAX package's ``cli/run.py`` for ``in=http out=jax``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from ..llm.http.service import HttpService, ModelManager
from ..llm.model_card import ModelDeploymentCard
from ..llm.preprocessor import (
    ChatPreprocessorOperator,
    DetokenizeOperator,
    OpenAIPreprocessor,
)
from ..runtime.pipeline import Pipeline

logger = logging.getLogger(__name__)


def parse_io(args: list[str]) -> tuple[str, str, list[str]]:
    """Extract the in=/out= positional specs."""
    in_spec, out_spec, rest = "http", "torch", []
    for a in args:
        if a.startswith("in="):
            in_spec = a[3:]
        elif a.startswith("out="):
            out_spec = a[4:]
        else:
            rest.append(a)
    return in_spec, out_spec, rest


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dynamo-run-torch", description="dynamo_tpu_torch launcher (in=http out=torch)"
    )
    p.add_argument("--model-path", default=None,
                   help="HF-layout model directory, or a .gguf file")
    p.add_argument("--model-name", default=None, help="served model name")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--host-cache-blocks", type=int, default=0,
                   help="host-RAM KV tier size in blocks (0 = disabled)")
    p.add_argument("--decode-steps", type=int, default=4,
                   help="decode steps per engine dispatch")
    p.add_argument("--seed", type=int, default=0, help="seed of random weights")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="tp ranks (Megatron heads, MLP and vocab), one per card")
    p.add_argument("--quantize", choices=("int8", "int8-all"), default=None,
                   help="weight-only int8: decode only, or every product")
    return p


def build_engine(out_spec: str, flags: argparse.Namespace):
    """(chat_engine, completions_engine, model_name, core_engine) for out=torch."""
    if out_spec != "torch":
        raise SystemExit(f"unknown out= engine: {out_spec!r} (this launcher serves out=torch)")
    if not flags.model_path:
        raise SystemExit("out=torch requires --model-path")
    from ..engine_torch.engine import build_torch_serving_engine

    card = ModelDeploymentCard.from_local_path(flags.model_path, flags.model_name)
    core = build_torch_serving_engine(
        card,
        max_batch_size=flags.max_batch_size,
        kv_block_size=flags.kv_block_size,
        max_model_len=flags.max_model_len,
        decode_steps=flags.decode_steps,
        host_cache_blocks=flags.host_cache_blocks,
        seed=flags.seed,
        device=flags.device,
        tensor_parallel_size=flags.tensor_parallel_size,
        quantize=flags.quantize,
    )
    core.warmup()
    chat, completions = make_pipelines(card, core)
    return chat, completions, flags.model_name or card.display_name, core


def make_pipelines(card: ModelDeploymentCard, core):
    """(chat, completions) pipelines: preprocessor → detokenizer → ``core``."""
    pre = OpenAIPreprocessor(card)

    def pipeline(chat: bool):
        return (
            Pipeline()
            .link(ChatPreprocessorOperator(pre, chat=chat))
            .link(DetokenizeOperator(card, pre.tokenizer))
            .link_engine(core)
        )

    return pipeline(True), pipeline(False)


def make_service(chat_engine, completions_engine, model_name: str,
                 flags: argparse.Namespace) -> HttpService:
    manager = ModelManager()
    manager.add_chat_model(model_name, chat_engine)
    manager.add_completions_model(model_name, completions_engine)
    return HttpService(manager, host=flags.host, port=flags.port)


async def run_http(chat_engine, completions_engine, model_name: str,
                   flags: argparse.Namespace, ready=None) -> None:
    """Serve until cancelled; ``ready(port)`` is called once listening."""
    service = make_service(chat_engine, completions_engine, model_name, flags)
    port = await service.start()
    logger.info("serving model %r on port %d", model_name, port)
    if ready is not None:
        ready(port)
    try:
        await asyncio.Event().wait()
    finally:
        await service.stop()


async def amain(argv: list[str]) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    in_spec, out_spec, rest = parse_io(argv)
    flags = build_parser().parse_args(rest)
    if in_spec != "http":
        raise SystemExit(f"unknown in= frontend: {in_spec!r} (this launcher serves in=http)")
    chat, comp, name, core = build_engine(out_spec, flags)
    try:
        await run_http(chat, comp, name, flags)
    finally:
        core.close()


def main() -> None:
    try:
        asyncio.run(amain(sys.argv[1:]))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
