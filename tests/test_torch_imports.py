"""Import hygiene of the port: ``dynamo_tpu_torch/``, ``chip_smoke.py`` and
``chip_ab.py`` import neither JAX nor the JAX package, their imports are the standard
library, torch, numpy and jinja2 only, and the launcher builds the engine
and answers a request with JAX, the JAX package and the JAX path's other
dependencies (the ``safetensors`` package among them) made unimportable:
from a directory without weights, a directory of ``*.safetensors`` files
and a ``.gguf`` file."""

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


# the modules of the weight path from disk to the card, and the MoE layer
WEIGHT_PATH_MODULES = ["dynamo_tpu_torch.engine_torch.safetensors", "dynamo_tpu_torch.llm.gguf",
                       "dynamo_tpu_torch.ops.int8_matmul", "dynamo_tpu_torch.ops.moe"]


@pytest.mark.parametrize("module", WEIGHT_PATH_MODULES)
def test_weight_path_module_imports_only_the_allowed(module):
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in _port_files()
    tops = {m.split(".")[0] for m in _absolute_imports(path)}
    assert not tops & set(BLOCKED), tops & set(BLOCKED)
    assert tops <= set(sys.stdlib_module_names) | ALLOWED_THIRD_PARTY | {"dynamo_tpu_torch"}


def _load_blocked(modules):
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import importlib
        for mod in {modules!r}:
            importlib.import_module(mod)
        loaded = {{m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}}
        assert not loaded & set({BLOCKED!r}), loaded & set({BLOCKED!r})
        print("IMPORTED")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "IMPORTED" in res.stdout


def test_weight_path_modules_load_with_jax_path_dependencies_blocked():
    _load_blocked(WEIGHT_PATH_MODULES)


# the integrity plane, the fault plane and speculative decoding: the port's
# own copies of the JAX package's modules, never imports of them
INTEGRITY_SPEC_MODULES = ["dynamo_tpu_torch.runtime.envknobs",
                          "dynamo_tpu_torch.runtime.integrity",
                          "dynamo_tpu_torch.runtime.faults",
                          "dynamo_tpu_torch.engine_torch.drafter"]


@pytest.mark.parametrize("module", INTEGRITY_SPEC_MODULES)
def test_integrity_and_spec_module_imports_only_the_allowed(module):
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in _port_files()
    tops = {m.split(".")[0] for m in _absolute_imports(path)}
    assert not tops & set(BLOCKED), tops & set(BLOCKED)
    assert tops <= set(sys.stdlib_module_names) | ALLOWED_THIRD_PARTY | {"dynamo_tpu_torch"}


def test_integrity_and_spec_modules_load_with_jax_path_dependencies_blocked():
    _load_blocked(INTEGRITY_SPEC_MODULES + ["dynamo_tpu_torch.engine_torch.engine"])


# tensor parallelism: the mesh and the collectives
PARALLEL_MODULES = ["dynamo_tpu_torch.parallel", "dynamo_tpu_torch.parallel.mesh",
                    "dynamo_tpu_torch.parallel.collectives"]


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_module_imports_only_the_allowed(module):
    parts = module.split(".")
    path = os.path.join(ROOT, *parts) + ".py"
    if not os.path.exists(path):
        path = os.path.join(ROOT, *parts, "__init__.py")
    assert path in _port_files()
    tops = {m.split(".")[0] for m in _absolute_imports(path)}
    assert not tops & set(BLOCKED), tops & set(BLOCKED)
    assert tops <= set(sys.stdlib_module_names) | ALLOWED_THIRD_PARTY | {"dynamo_tpu_torch"}


def test_parallel_modules_load_with_jax_path_dependencies_blocked():
    _load_blocked(PARALLEL_MODULES + ["dynamo_tpu_torch.models.llama"])


def _serve_blocked(model_path, embed_row=None):
    """Build the launcher's engine on ``model_path`` in a fresh interpreter
    with the BLOCKED modules unimportable, answer one chat request, and (when
    given) check row 1 of the embedding against ``embed_row``."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of these raises ImportError
        sys.path.insert(0, {ROOT!r})
        import asyncio, json
        from dynamo_tpu_torch.cli.run import build_engine, build_parser
        from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
        from dynamo_tpu_torch.runtime.engine import Context
        flags = build_parser().parse_args(["--model-path", {model_path!r}, "--device", "cpu"])
        chat, comp, name, core = build_engine("torch", flags)
        if {embed_row!r} is not None:
            assert core.params.embed[1, :4].float().tolist() == {embed_row!r}

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


def test_launcher_serves_with_jax_path_dependencies_blocked(model_dir):
    _serve_blocked(model_dir)


@pytest.mark.parametrize("kind", ["safetensors", "gguf"])
def test_launcher_serves_weight_files_with_jax_path_dependencies_blocked(kind, tmp_path):
    from tests.fixtures import build_model_dir
    from tests.torch_checkpoints import hf_tensors, write_safetensors, write_tiny_gguf
    from dynamo_tpu_torch.engine_torch.weights import config_from_card
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    path = build_model_dir(str(tmp_path / "tiny"))
    cfg = config_from_card(ModelDeploymentCard.from_local_path(path))
    tensors = hf_tensors(cfg, 5)
    if kind == "safetensors":
        write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    else:
        path = write_tiny_gguf(str(tmp_path / "tiny.gguf"), cfg, tensors)
    row = torch.from_numpy(tensors["model.embed_tokens.weight"][1, :4]).bfloat16()
    _serve_blocked(path, row.float().tolist())


def test_launcher_refuses_cpu_fallback_without_a_card(model_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        asyncio.run(amain(["in=http", "out=torch", "--model-path", model_dir, "--port", "0"]))


# the observability planes: the port's own copies of the JAX package's
# tracing, telemetry, profiling, straggler and health modules, the service
# metrics, the device timer and the dispatch gate's wrapper
OBSERVABILITY_MODULES = ["dynamo_tpu_torch.runtime.tracing",
                         "dynamo_tpu_torch.runtime.telemetry",
                         "dynamo_tpu_torch.runtime.profiling",
                         "dynamo_tpu_torch.runtime.straggler",
                         "dynamo_tpu_torch.runtime.health",
                         "dynamo_tpu_torch.llm.http.metrics",
                         "dynamo_tpu_torch.engine_torch.device_timer",
                         "dynamo_tpu_torch.ops.dispatch_gate"]


@pytest.mark.parametrize("module", OBSERVABILITY_MODULES)
def test_observability_module_imports_only_the_allowed(module):
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in _port_files()
    tops = {m.split(".")[0] for m in _absolute_imports(path)}
    assert not tops & set(BLOCKED), tops & set(BLOCKED)
    assert tops <= set(sys.stdlib_module_names) | ALLOWED_THIRD_PARTY | {"dynamo_tpu_torch"}


def test_observability_modules_load_with_jax_path_dependencies_blocked():
    _load_blocked(OBSERVABILITY_MODULES + ["dynamo_tpu_torch.llm.http.service"])
