"""Checkpoints on disk for the port's weight-loading tests: HF-named random
weights, a minimal safetensors writer (no ``safetensors`` package), and a
GGUF export of the tiny model through ``tests/test_gguf.py``'s writer."""

from __future__ import annotations

import json
import struct

import numpy as np

_ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
              np.dtype(np.int8): "I8", np.dtype(np.int32): "I32", np.dtype(np.int64): "I64"}


def write_safetensors(path: str, tensors: dict) -> str:
    """numpy arrays (or ``(uint16 array, "BF16")`` pairs of raw bf16 bits)
    in the safetensors layout: u64 header length, JSON header, buffers."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, arr in tensors.items():
        arr, dtype = arr if isinstance(arr, tuple) else (arr, _ST_DTYPES[arr.dtype])
        blob = np.ascontiguousarray(arr).tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + b"".join(blobs))
    return path


def hf_tensors(c, seed: int) -> dict:
    """fp32 weights under the HF llama/qwen2 names for a LlamaConfig-like
    ``c`` ([out, in] matrices; qwen2 biases when ``c.qkv_bias``; no
    ``lm_head.weight`` when tied)."""
    rng = np.random.default_rng(seed)
    E, F, V = c.hidden_size, c.intermediate_size, c.vocab_size
    q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim

    def mat(o, i):
        return (rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.normal(size=(E,))).astype(np.float32)

    t = {"model.embed_tokens.weight": mat(V, E), "model.norm.weight": norm()}
    if not c.tie_embeddings:
        t["lm_head.weight"] = mat(V, E)
    for i in range(c.num_layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": norm(),
            p + "post_attention_layernorm.weight": norm(),
            p + "self_attn.q_proj.weight": mat(q, E),
            p + "self_attn.k_proj.weight": mat(kv, E),
            p + "self_attn.v_proj.weight": mat(kv, E),
            p + "self_attn.o_proj.weight": mat(E, q),
            p + "mlp.gate_proj.weight": mat(F, E),
            p + "mlp.up_proj.weight": mat(F, E),
            p + "mlp.down_proj.weight": mat(E, F),
        })
        if c.qkv_bias:
            for name, n in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
                t[f"{p}self_attn.{name}.bias"] = (0.5 * rng.normal(size=(n,))).astype(np.float32)
    return t


def write_tiny_gguf(path: str, c, tensors: dict) -> str:
    """A llama GGUF of the HF-named ``tensors`` with the byte-level BPE
    tokenizer and chat template of ``tests/fixtures.py`` embedded
    (``c.vocab_size`` must be its vocabulary size)."""
    from dynamo_tpu.llm import gguf as G
    from tests.fixtures import CHAT_TEMPLATE, build_tokenizer
    from tests.test_gguf import write_gguf

    tk = build_tokenizer()
    tkj = json.loads(tk.to_str())
    vocab = sorted(tkj["model"]["vocab"], key=tkj["model"]["vocab"].get)
    assert len(vocab) == c.vocab_size
    merges = [m if isinstance(m, str) else " ".join(m) for m in tkj["model"]["merges"]]
    types = [1] * len(vocab)
    for sp in ("<s>", "</s>", "<|user|>", "<|assistant|>", "<|system|>"):
        types[tk.token_to_id(sp)] = 3  # CONTROL
    md = [
        ("general.architecture", G.T_STRING, "llama"),
        ("llama.embedding_length", G.T_UINT32, c.hidden_size),
        ("llama.block_count", G.T_UINT32, c.num_layers),
        ("llama.feed_forward_length", G.T_UINT32, c.intermediate_size),
        ("llama.attention.head_count", G.T_UINT32, c.num_heads),
        ("llama.attention.head_count_kv", G.T_UINT32, c.num_kv_heads),
        ("llama.rope.freq_base", G.T_FLOAT32, c.rope_theta),
        ("llama.attention.layer_norm_rms_epsilon", G.T_FLOAT32, c.rms_norm_eps),
        ("llama.context_length", G.T_UINT32, 256),
        ("tokenizer.ggml.model", G.T_STRING, "gpt2"),
        ("tokenizer.ggml.tokens", G.T_ARRAY, (G.T_STRING, vocab)),
        ("tokenizer.ggml.merges", G.T_ARRAY, (G.T_STRING, merges)),
        ("tokenizer.ggml.token_type", G.T_ARRAY, (G.T_INT32, types)),
        ("tokenizer.ggml.bos_token_id", G.T_UINT32, tk.token_to_id("<s>")),
        ("tokenizer.ggml.eos_token_id", G.T_UINT32, tk.token_to_id("</s>")),
        ("tokenizer.chat_template", G.T_STRING, CHAT_TEMPLATE),
    ]
    names = {"input_layernorm": "attn_norm", "post_attention_layernorm": "ffn_norm",
             "self_attn.q_proj": "attn_q", "self_attn.k_proj": "attn_k",
             "self_attn.v_proj": "attn_v", "self_attn.o_proj": "attn_output",
             "mlp.gate_proj": "ffn_gate", "mlp.up_proj": "ffn_up", "mlp.down_proj": "ffn_down"}
    g = {"token_embd.weight": tensors["model.embed_tokens.weight"],
         "output_norm.weight": tensors["model.norm.weight"]}
    if "lm_head.weight" in tensors:
        g["output.weight"] = tensors["lm_head.weight"]
    for i in range(c.num_layers):
        for hf, gg in names.items():
            g[f"blk.{i}.{gg}.weight"] = tensors[f"model.layers.{i}.{hf}.weight"]
    return write_gguf(path, md, g)
