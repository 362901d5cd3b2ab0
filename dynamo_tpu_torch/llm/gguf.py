"""GGUF model files: metadata, tokenizer and tensors, for the torch engine.

The port's copy of the JAX package's ``llm/gguf.py`` (which has no JAX in it
apart from ``gguf_params``). It parses the GGUF container (magic ``GGUF``,
little-endian, v2/v3): header → metadata key/values → tensor infos →
aligned tensor data. From one .gguf file it recovers

- the model config (``llama.*``/``qwen2.*`` metadata) as an HF-config dict,
- the embedded byte-level BPE tokenizer (``tokenizer.ggml.*``) as an HF
  ``tokenizer.json`` the port's tokenizer reads,
- F32/F16/BF16 tensors as numpy arrays, and :func:`gguf_params` the whole
  model as :class:`LlamaParams`. Quantized GGML block types are rejected,
  as the JAX reader rejects them.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types (spec)
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32 = 0, 1, 2, 3, 4, 5
T_FLOAT32, T_BOOL, T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = (
    6, 7, 8, 9, 10, 11, 12,
)

# ggml tensor dtypes we can load directly
GGML_F32, GGML_F16 = 0, 1
GGML_BF16 = 30
# BF16 has no portable numpy dtype: read raw uint16 and upconvert via a
# <<16 bit shift into float32 (exact — bf16 is float32's top half)
_LOADABLE = {GGML_F32: np.float32, GGML_F16: np.float16, GGML_BF16: np.uint16}

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f", T_UINT64: "<Q",
    T_INT64: "<q", T_FLOAT64: "<d",
}


@dataclass
class GgufTensorInfo:
    name: str
    shape: Tuple[int, ...]  # logical shape, row-major (reversed from file)
    ggml_type: int
    offset: int  # relative to data section start


@dataclass
class GgufFile:
    path: str
    version: int
    metadata: Dict[str, Any]
    tensors: Dict[str, GgufTensorInfo]
    data_start: int
    alignment: int

    # -- convenience -----------------------------------------------------------

    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "unknown")

    def arch_key(self, key: str) -> Any:
        return self.metadata.get(f"{self.architecture}.{key}")

    def load_tensor(self, name: str) -> np.ndarray:
        info = self.tensors.get(name)
        if info is None:
            raise KeyError(f"tensor {name!r} not in {self.path}")
        if info.ggml_type not in _LOADABLE:
            raise ValueError(
                f"tensor {name!r} has ggml type {info.ggml_type} (quantized?) — "
                "only F32/F16/BF16 GGUF tensors are loadable; re-export unquantized"
            )
        dt = _LOADABLE[info.ggml_type]
        count = int(np.prod(info.shape)) if info.shape else 1
        with open(self.path, "rb") as f:
            f.seek(self.data_start + info.offset)
            raw = f.read(count * np.dtype(dt).itemsize)
        arr = np.frombuffer(raw, dtype=dt)
        if info.ggml_type == GGML_BF16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.reshape(info.shape)


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    fmt = _SCALAR_FMT.get(vtype)
    if fmt is not None:
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vtype == T_BOOL:
        return bool(f.read(1)[0])
    if vtype == T_STRING:
        return _read_str(f)
    if vtype == T_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"unknown GGUF metadata type {vtype}")


def read_gguf(path: str) -> GgufFile:
    """Parse header, metadata, and tensor infos (tensor data stays on disk)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path} is not a GGUF file (magic {magic:#x})")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        tensor_count, kv_count = struct.unpack("<QQ", f.read(16))

        metadata: Dict[str, Any] = {}
        for _ in range(kv_count):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            metadata[key] = _read_value(f, vtype)

        tensors: Dict[str, GgufTensorInfo] = {}
        for _ in range(tensor_count):
            name = _read_str(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            (ggml_type,) = struct.unpack("<I", f.read(4))
            (offset,) = struct.unpack("<Q", f.read(8))
            # GGUF stores dims innermost-first; numpy wants row-major
            tensors[name] = GgufTensorInfo(
                name=name, shape=tuple(reversed(dims)),
                ggml_type=ggml_type, offset=offset,
            )

        alignment = int(metadata.get("general.alignment", 32))
        pos = f.tell()
        data_start = (pos + alignment - 1) // alignment * alignment
        return GgufFile(
            path=path, version=version, metadata=metadata, tensors=tensors,
            data_start=data_start, alignment=alignment,
        )


# ---------------------------------------------------------------------------
# tokenizer extraction → HF tokenizer.json
# ---------------------------------------------------------------------------


def write_hf_tokenizer(gguf: GgufFile, out_dir: str) -> str:
    """Convert the embedded ``tokenizer.ggml.*`` vocab to HF tokenizer files.

    Supports the ``gpt2`` (byte-level BPE) tokenizer model, which covers the
    llama3/qwen GGUF exports this framework serves. Writes tokenizer.json +
    tokenizer_config.json (chat template included when embedded) and returns
    out_dir.
    """
    md = gguf.metadata
    model = md.get("tokenizer.ggml.model")
    if model != "gpt2":
        raise ValueError(
            f"embedded tokenizer model {model!r} unsupported (byte-level BPE "
            "'gpt2' only)"
        )
    tokens: List[str] = md["tokenizer.ggml.tokens"]
    merges: List[str] = md.get("tokenizer.ggml.merges", [])
    token_types: List[int] = md.get("tokenizer.ggml.token_type", [])

    vocab = {tok: i for i, tok in enumerate(tokens)}
    added = [
        {
            "id": i, "content": tokens[i], "single_word": False,
            "lstrip": False, "rstrip": False, "normalized": False,
            "special": True,
        }
        for i, t in enumerate(token_types)
        if t == 3  # CONTROL
    ]
    tokenizer_json = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {
            "type": "ByteLevel", "add_prefix_space": False,
            "trim_offsets": True, "use_regex": True,
        },
        "post_processor": None,
        "decoder": {
            "type": "ByteLevel", "add_prefix_space": True,
            "trim_offsets": True, "use_regex": True,
        },
        "model": {
            "type": "BPE",
            "dropout": None,
            "unk_token": None,
            "continuing_subword_prefix": None,
            "end_of_word_suffix": None,
            "fuse_unk": False,
            "byte_fallback": False,
            "vocab": vocab,
            "merges": [m.split(" ", 1) for m in merges],
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tokenizer.json"), "w") as f:
        json.dump(tokenizer_json, f)

    bos_id = md.get("tokenizer.ggml.bos_token_id")
    eos_id = md.get("tokenizer.ggml.eos_token_id")
    tok_cfg = {
        "bos_token": tokens[bos_id] if bos_id is not None else None,
        "eos_token": tokens[eos_id] if eos_id is not None else None,
        "chat_template": md.get("tokenizer.chat_template"),
    }
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({k: v for k, v in tok_cfg.items() if v is not None}, f)
    return out_dir


# ---------------------------------------------------------------------------
# model config extraction
# ---------------------------------------------------------------------------


def model_config_dict(gguf: GgufFile) -> dict:
    """``llama.*`` metadata → the HF-config-shaped dict that
    ``engine_torch/weights.py::config_from_card`` reads (config.json's keys)."""
    if gguf.architecture not in ("llama", "qwen2"):
        raise ValueError(f"unsupported GGUF architecture {gguf.architecture!r}")
    heads = int(gguf.arch_key("attention.head_count"))
    kv_heads = int(gguf.arch_key("attention.head_count_kv") or heads)
    embed = int(gguf.arch_key("embedding_length"))
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": gguf.architecture,
        "vocab_size": len(gguf.metadata.get("tokenizer.ggml.tokens", []))
        or int(gguf.arch_key("vocab_size") or 0),
        "hidden_size": embed,
        "intermediate_size": int(gguf.arch_key("feed_forward_length")),
        "num_hidden_layers": int(gguf.arch_key("block_count")),
        "num_attention_heads": heads,
        "num_key_value_heads": kv_heads,
        "head_dim": embed // heads,
        "rope_theta": float(gguf.arch_key("rope.freq_base") or 10000.0),
        "rms_norm_eps": float(
            gguf.arch_key("attention.layer_norm_rms_epsilon") or 1e-5
        ),
        "max_position_embeddings": int(gguf.arch_key("context_length") or 4096),
        "bos_token_id": gguf.metadata.get("tokenizer.ggml.bos_token_id"),
        "eos_token_id": gguf.metadata.get("tokenizer.ggml.eos_token_id"),
        "tie_word_embeddings": "output.weight" not in gguf.tensors,
    }


def extract_model_dir(gguf_path: str, out_dir: Optional[str] = None) -> str:
    """One-call GGUF → HF-layout directory (config.json + tokenizer files).

    The serving stack consumes HF-layout dirs (ModelDeploymentCard); this
    materializes one next to the .gguf so ``--model-path model.gguf`` works
    end-to-end. Weight tensors stay in the .gguf (see gguf_params()).
    """
    gguf = read_gguf(gguf_path)
    out_dir = out_dir or gguf_path + ".hf"
    os.makedirs(out_dir, exist_ok=True)
    write_hf_tokenizer(gguf, out_dir)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(model_config_dict(gguf), f, indent=1)
    return out_dir


# GGUF ↔ framework tensor-name mapping (llama family)
_TENSOR_MAP = {
    "token_embd.weight": "embed",
    "output_norm.weight": "final_norm",
    "output.weight": "lm_head",
}
_LAYER_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "mlp_norm",
    "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
}


def gguf_params(gguf: GgufFile, config, device="cpu"):
    """Load GGUF tensors into :class:`LlamaParams` on ``device``, one tensor
    at a time (the JAX ``gguf_params``). GGUF stores projection matrices as
    [out, in]; the port computes ``x @ W`` with W [in, out], so weights
    transpose on load. Tensors go through fp32 (as in the JAX reader);
    matrices take the config dtype, norms and biases fp32."""
    from ..models.llama import LlamaParams

    params = LlamaParams(config, torch.device(device))
    tied = "output.weight" not in gguf.tensors
    if tied != config.tie_embeddings:
        raise ValueError(f"{gguf.path}: output.weight {'absent' if tied else 'present'} but "
                         f"tie_embeddings={config.tie_embeddings}")

    def put(dst: torch.Tensor, name: str, transpose: bool = False) -> None:
        t = torch.from_numpy(np.array(gguf.load_tensor(name), dtype=np.float32))
        t = t.to(dst.device)
        dst.copy_(t.T if transpose else t)

    layer_map = dict(_LAYER_MAP)
    if config.qkv_bias:
        # qwen2-family GGUFs carry attention biases
        layer_map.update({"attn_q.bias": "bq", "attn_k.bias": "bk", "attn_v.bias": "bv"})
    with torch.no_grad():
        put(params.embed, "token_embd.weight")
        put(params.final_norm, "output_norm.weight")
        if not tied:
            put(params.lm_head, "output.weight", transpose=True)
        for i in range(config.num_layers):
            for gname, pname in layer_map.items():
                put(params.layers[pname][i], f"blk.{i}.{gname}",
                    transpose=gname.endswith(".weight") and not gname.endswith("norm.weight"))
    return params
