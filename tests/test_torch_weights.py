"""The port's weight loading against the JAX package's, on the CPU in fp32.

- The port's safetensors reader gives the ``safetensors`` package's tensors
  bit for bit, and ``load_params`` reads a directory with that package made
  unimportable.
- ``params_from_hf`` gives the logits of the JAX ``params_from_hf`` on the
  same tensors (llama untied; qwen2 tied, with biases) within 1e-5.
- Golden: an HF ``transformers`` tiny model's logits against the port's
  forward on its saved safetensors (llama, qwen2).
- GGUF: ``read_gguf``/``gguf_params`` against the JAX package's (logits
  within 1e-5), a ``.gguf`` card serving the JAX engine's greedy tokens, and
  a quantized GGML type refused.
"""

import asyncio
import dataclasses
import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine_jax import weights as jw
from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.llm import gguf as jgguf
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.llm.tokenizer import HFTokenizer as JaxTokenizer
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine_torch import weights as tw
from dynamo_tpu_torch.engine_torch.engine import build_torch_serving_engine
from dynamo_tpu_torch.engine_torch.safetensors import SafetensorsFile
from dynamo_tpu_torch.llm import gguf as tgguf
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.runtime.engine import Context
from tests.fixtures import build_model_dir
from tests.torch_checkpoints import hf_tensors, write_safetensors, write_tiny_gguf

ATOL = 1e-5
PROMPT = [3, 17, 91, 5, 44, 101, 7, 63]


def _configs(**kw):
    jc = dataclasses.replace(jl.LLAMA_PRESETS["tiny"], dtype=jnp.float32, **kw)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(tl.LlamaConfig)
              if f.name != "dtype"}
    return jc, tl.LlamaConfig(dtype=torch.float32, **fields)


def _jax_logits(jp, jc, prompt=PROMPT):
    cache = jl.make_kv_cache(jc, 8, 8, dtype=jnp.float32)
    tables = jnp.arange(8, dtype=jnp.int32)[None]
    logits, _ = jl.forward(jp, jc, jnp.asarray([prompt], jnp.int32),
                           jnp.arange(len(prompt))[None], cache, tables, use_pallas=False)
    return np.asarray(logits[0], np.float32)


def _port_logits(tp, tc, prompt=PROMPT):
    cache = tl.make_kv_cache(tc, 8, 8, dtype=torch.float32)
    tables = torch.arange(8, dtype=torch.int32)[None]
    logits, _ = tl.forward(tp, tc, torch.tensor([prompt], dtype=torch.int32),
                           torch.arange(len(prompt))[None], cache, tables)
    return logits[0].numpy()


# -- safetensors ---------------------------------------------------------------

def test_reader_matches_the_safetensors_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    sn = pytest.importorskip("safetensors.numpy")
    gen = torch.Generator().manual_seed(0)
    want = {
        "bf16": torch.randn(5, 7, generator=gen).bfloat16(),
        "f16": torch.randn(3, 2, 4, generator=gen).half(),
        "f32": torch.randn(9, generator=gen),
        "i8": torch.randint(-128, 128, (4, 6), generator=gen, dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (3,), generator=gen, dtype=torch.int32),
        "i64": torch.randint(-2**40, 2**40, (2, 2), generator=gen, dtype=torch.int64),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 3),
    }
    path = str(tmp_path / "a.safetensors")
    st.save_file(want, path, metadata={"note": "ignored"})
    got = SafetensorsFile(path)
    ref = st.load_file(path)
    assert set(got) == set(ref)
    for name, t in ref.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape, name
        assert torch.equal(got[name], t), name
    # numpy has no bf16: the other dtypes against the numpy loader too
    (tmp_path / "b").mkdir()
    npath = str(tmp_path / "b" / "b.safetensors")
    st.save_file({k: v for k, v in want.items() if k != "bf16"}, npath)
    for name, a in sn.load_file(npath).items():
        np.testing.assert_array_equal(SafetensorsFile(npath)[name].numpy(), a)


def test_reader_refuses_an_unknown_dtype(tmp_path):
    header = json.dumps({"w": {"dtype": "F64", "shape": [2], "data_offsets": [0, 16]}}).encode()
    path = tmp_path / "f64.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 16)
    with pytest.raises(ValueError, match="'w' has dtype 'F64'"):
        SafetensorsFile(str(path))


@pytest.fixture(scope="module")
def model_dir_with_weights(tmp_path_factory):
    """tests/fixtures.py's model directory plus its weights, split over two
    safetensors files written without the safetensors package."""
    path = build_model_dir(str(tmp_path_factory.mktemp("tiny-st")))
    card = ModelDeploymentCard.from_local_path(path)
    tensors = hf_tensors(tw.config_from_card(card), 7)
    names = sorted(tensors)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        write_safetensors(os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"),
                          {n: tensors[n] for n in part})
    return path, tensors


def test_load_params_needs_no_safetensors_package(model_dir_with_weights, monkeypatch):
    monkeypatch.setitem(sys.modules, "safetensors", None)
    path, tensors = model_dir_with_weights
    card = ModelDeploymentCard.from_local_path(path)
    cfg = tw.config_from_card(card, dtype=torch.float32)
    params = tw.load_params(card, cfg, device="cpu")
    assert torch.equal(params.embed, torch.from_numpy(tensors["model.embed_tokens.weight"]))
    assert torch.equal(params.lm_head.T, torch.from_numpy(tensors["lm_head.weight"]))
    assert torch.equal(params.layers["w_down"][1].T,
                       torch.from_numpy(tensors["model.layers.1.mlp.down_proj.weight"]))
    assert torch.equal(params.layers["mlp_norm"][0], torch.from_numpy(
        tensors["model.layers.0.post_attention_layernorm.weight"]))
    # bf16 on disk, bf16 config: the same bits, no upcast on the way
    bf = {n: (torch.from_numpy(a).bfloat16().view(torch.int16).numpy(), "BF16")
          for n, a in tensors.items()}
    bf_dir = os.path.join(os.path.dirname(path), "bf16")
    os.makedirs(bf_dir, exist_ok=True)
    write_safetensors(os.path.join(bf_dir, "model.safetensors"), bf)
    params = tw.params_from_hf(SafetensorsFile(os.path.join(bf_dir, "model.safetensors")),
                               tw.config_from_card(card))
    assert params.layers["wq"].dtype == torch.bfloat16
    want = torch.from_numpy(tensors["model.layers.0.self_attn.q_proj.weight"]).bfloat16()
    assert torch.equal(params.layers["wq"][0].T.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("family,kw", [
    ("llama", dict(tie_embeddings=False)),
    ("qwen2", dict(tie_embeddings=True, qkv_bias=True)),
], ids=["llama-untied", "qwen2-tied-biases"])
def test_params_from_hf_matches_jax(family, kw):
    jc, tc = _configs(**kw)
    tensors = hf_tensors(tc, 3)
    if kw["tie_embeddings"]:
        assert "lm_head.weight" not in tensors
    tp = tw.params_from_hf(tensors, tc)
    jp = jw.params_from_hf(tensors, jc)
    np.testing.assert_allclose(_port_logits(tp, tc), _jax_logits(jp, jc), atol=ATOL, rtol=0)
    if kw.get("qkv_bias"):
        np.testing.assert_array_equal(tp.layers["bk"][1].numpy(),
                                      tensors["model.layers.1.self_attn.k_proj.bias"])


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_hf_golden(family, tmp_path):
    """A transformers model saved with save_pretrained (safetensors) and
    served through the port's card, config and loader: its logits within
    2e-3 of the model's scale, and the same argmax everywhere (the check of
    tests/test_weights_golden.py)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0 if family == "llama" else 1)
    common = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=1, rope_theta=10000.0)
    if family == "llama":
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            head_dim=16, rms_norm_eps=1e-5, tie_word_embeddings=False, **common))
    else:
        hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            rms_norm_eps=1e-6, tie_word_embeddings=True, **common))
        with torch.no_grad():  # qwen2 ships nonzero attention biases
            for layer in hf.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.uniform_(-0.5, 0.5)
    hf = hf.eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    card = ModelDeploymentCard.from_local_path(str(tmp_path))
    cfg = tw.config_from_card(card, dtype=torch.float32)
    assert cfg.tie_embeddings == (family == "qwen2") and cfg.qkv_bias == (family == "qwen2")
    ours = _port_logits(tw.load_params(card, cfg, device="cpu"), cfg)
    with torch.no_grad():
        theirs = hf(torch.tensor([PROMPT])).logits[0].float().numpy()
    err, scale = np.abs(ours - theirs).max(), np.abs(theirs).max()
    assert err <= 2e-3 * max(scale, 1.0), (family, err, scale)
    assert (ours.argmax(-1) == theirs.argmax(-1)).all()


# -- GGUF ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    from tests.fixtures import build_tokenizer

    jc, tc = _configs(vocab_size=build_tokenizer().get_vocab_size())
    tensors = hf_tensors(tc, 9)
    path = str(tmp_path_factory.mktemp("gguf") / "tiny.gguf")
    return write_tiny_gguf(path, tc, tensors), jc, tc


def test_gguf_reader_and_params_match_jax(tiny_gguf):
    path, jc, tc = tiny_gguf
    tg, jg = tgguf.read_gguf(path), jgguf.read_gguf(path)
    assert tg.metadata == jg.metadata and tg.data_start == jg.data_start
    assert {n: (i.shape, i.ggml_type, i.offset) for n, i in tg.tensors.items()} == \
        {n: (i.shape, i.ggml_type, i.offset) for n, i in jg.tensors.items()}
    assert tgguf.model_config_dict(tg) == jgguf.model_config_dict(jg)
    tp = tgguf.gguf_params(tg, tc)
    jp = jgguf.gguf_params(jg, jc, dtype=jnp.float32)
    np.testing.assert_allclose(_port_logits(tp, tc), _jax_logits(jp, jc), atol=ATOL, rtol=0)


def test_gguf_quantized_type_is_refused(tiny_gguf):
    g = tgguf.read_gguf(tiny_gguf[0])
    g.tensors["token_embd.weight"].ggml_type = 2  # Q4_0
    with pytest.raises(ValueError, match="quantized"):
        g.load_tensor("token_embd.weight")
    with pytest.raises(ValueError, match="quantized"):
        tgguf.gguf_params(g, tiny_gguf[2])


async def _greedy(engine, common, ctx_cls, prompt, n):
    req = common.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=common.StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=common.SamplingOptions(temperature=0.0),
    )
    out = []
    async for item in engine.generate(ctx_cls(req)):
        if item.data is not None:
            out.extend(item.data.get("token_ids", []))
    return out


def test_gguf_card_serves_the_jax_engines_tokens(tiny_gguf):
    path, jc, _ = tiny_gguf
    card = ModelDeploymentCard.from_local_path(path)
    jcard = JaxCard.from_local_path(path)
    assert card.gguf_path == path and card.display_name == "tiny"
    assert card.mdcsum == jcard.mdcsum and card.context_length == 256
    text = "hello world, the quick brown fox"
    ids = HFTokenizer.from_file(card.tokenizer_file).encode(text)
    assert ids == JaxTokenizer.from_file(jcard.tokenizer_file).encode(text)
    core = build_torch_serving_engine(card, max_batch_size=2, kv_block_size=8, max_model_len=64,
                                      decode_steps=2, device="cpu", dtype=torch.float32)
    jcfg = jw.config_from_card(jcard, dtype=jnp.float32)
    jeng = JaxServingEngine(jcfg, jw.load_params(jcard, jcfg), JaxEngineConfig(
        max_slots=2, kv_block_size=8, max_model_len=64, decode_steps=2))
    try:
        got = asyncio.run(_greedy(core, tcommon, Context, ids, 8))
        want = asyncio.run(_greedy(jeng, jcommon, JaxContext, ids, 8))
    finally:
        core.close()
        jeng.close()
    assert got == want and len(got) == 8
