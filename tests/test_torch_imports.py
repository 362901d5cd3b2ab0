"""Import hygiene of the port: ``dynamo_tpu_torch/``, ``chip_smoke.py`` and
``chip_ab.py`` import neither JAX nor the JAX package, their imports are the standard
library, torch, numpy and jinja2 only, and the launcher builds the engine
and answers a request with JAX, the JAX package and the JAX path's other
dependencies made unimportable."""

import ast
import asyncio
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from dynamo_tpu_torch.cli.run import amain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWED_THIRD_PARTY = {"torch", "numpy", "jinja2"}
BLOCKED = ["jax", "jaxlib", "dynamo_tpu", "aiohttp", "pydantic", "tokenizers", "xxhash",
           "safetensors", "triton", "huggingface_hub"]


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "chip_ab.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "dynamo_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _absolute_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_only_stdlib_torch_numpy_jinja2():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _absolute_imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "dynamo_tpu"):
                bad.append((path, mod))
            elif top != "dynamo_tpu_torch" and top not in sys.stdlib_module_names \
                    and top not in ALLOWED_THIRD_PARTY:
                bad.append((path, mod))
    assert not bad, bad


def test_launcher_serves_with_jax_path_dependencies_blocked(model_dir):
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of these raises ImportError
        sys.path.insert(0, {ROOT!r})
        import asyncio, json
        from dynamo_tpu_torch.cli.run import build_engine, build_parser
        from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
        from dynamo_tpu_torch.runtime.engine import Context
        flags = build_parser().parse_args(["--model-path", {model_dir!r}, "--device", "cpu"])
        chat, comp, name, core = build_engine("torch", flags)

        async def go():
            req = ChatCompletionRequest.from_dict({{"model": name, "max_tokens": 4,
                "messages": [{{"role": "user", "content": "hi"}}]}})
            return [i.data async for i in chat.generate(Context(req)) if i.data]

        items = asyncio.run(go())
        core.close()
        assert items[-1]["choices"][0]["finish_reason"], items
        loaded = {{m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}}
        assert not loaded & set({BLOCKED!r}), loaded & set({BLOCKED!r})
        print("SERVED", len(items))
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "SERVED" in res.stdout


def test_launcher_refuses_cpu_fallback_without_a_card(model_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        asyncio.run(amain(["in=http", "out=torch", "--model-path", model_dir, "--port", "0"]))
