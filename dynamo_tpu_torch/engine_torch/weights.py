"""Model config resolution and weight loading for the torch engine.

Maps an HF-layout model directory onto :class:`LlamaConfig` and its weights
onto :class:`LlamaParams`, as the JAX package's ``engine_jax/weights.py``
does: a card with a ``gguf_path`` loads the GGUF file (``llm/gguf.py``), a
directory with ``*.safetensors`` files loads those (``safetensors.py``, the
port's own reader), and a directory without weight files gets deterministic
random weights made on the device. Tensors go to the device one at a time.
:func:`params_from_numpy` carries the JAX package's parameter pytree across
(its int8 tree too), so both packages compute the same function in the
tests.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from ..llm.model_card import ModelDeploymentCard
from ..models.llama import LlamaConfig, LlamaParams, init_params
from .safetensors import hf_tensors

logger = logging.getLogger(__name__)

# HF module name of each stacked matrix (nn.Linear weights, [out, in])
_HF_MATS = {
    "wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}


def config_from_card(card: ModelDeploymentCard, dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Derive a LlamaConfig from the card's HF config.json contents."""
    mc = card.model_config or {}
    if int(mc.get("num_local_experts", 0) or 0) > 1:
        raise ValueError("MoE models are not supported by the torch engine yet")
    hidden = int(mc.get("hidden_size", 4096))
    heads = int(mc.get("num_attention_heads", 32))
    return LlamaConfig(
        vocab_size=int(mc.get("vocab_size", 128256)),
        hidden_size=hidden,
        intermediate_size=int(mc.get("intermediate_size", 4 * hidden)),
        num_layers=int(mc.get("num_hidden_layers", 32)),
        num_heads=heads,
        num_kv_heads=int(mc.get("num_key_value_heads", heads)),
        head_dim=int(mc.get("head_dim", hidden // heads)),
        rope_theta=float(mc.get("rope_theta", 500000.0)),
        rms_norm_eps=float(mc.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(mc.get("tie_word_embeddings", False)),
        qkv_bias=mc.get("model_type") == "qwen2",
        dtype=dtype,
    )


def load_params(card: ModelDeploymentCard, config: LlamaConfig, seed: int = 0,
                device="cuda") -> LlamaParams:
    """Load llama weights (GGUF or safetensors) onto ``device``, or
    random-initialise there when the card has no weight files."""
    gguf_path = getattr(card, "gguf_path", None)
    if gguf_path:
        from ..llm.gguf import gguf_params, read_gguf

        return gguf_params(read_gguf(gguf_path), config, device=device)
    tensors = hf_tensors(card.model_path) if card.model_path else None
    if tensors is None:
        logger.info("no weight files for %s: random-initializing", card.display_name)
        return init_params(config, seed=seed, device=device)
    return params_from_hf(tensors, config, device=device)


def params_from_hf(tensors: Mapping[str, Union[torch.Tensor, np.ndarray]], config: LlamaConfig,
                   device="cpu") -> LlamaParams:
    """HF llama/qwen2 naming → :class:`LlamaParams` on ``device``: ``[out,
    in]`` matrices transposed to ``[in, out]``, layers stacked, the qwen2
    ``bq/bk/bv`` added and ``tie_word_embeddings`` honoured (no
    ``lm_head.weight`` is read). Norms and biases are fp32, matrices the
    config dtype. Each tensor is copied to the device as stored, then
    transposed and converted there, one at a time."""
    c = config
    params = LlamaParams(c, torch.device(device))

    def put(dst: torch.Tensor, name: str, transpose: bool = False) -> None:
        t = tensors[name]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        t = t.to(dst.device)
        dst.copy_(t.T if transpose else t)

    lp = params.layers
    with torch.no_grad():
        put(params.embed, "model.embed_tokens.weight")
        put(params.final_norm, "model.norm.weight")
        if not c.tie_embeddings:
            put(params.lm_head, "lm_head.weight", transpose=True)
        for i in range(c.num_layers):
            pre = f"model.layers.{i}."
            put(lp["attn_norm"][i], pre + "input_layernorm.weight")
            put(lp["mlp_norm"][i], pre + "post_attention_layernorm.weight")
            for ours, hf in _HF_MATS.items():
                put(lp[ours][i], f"{pre}{hf}.weight", transpose=True)
            if c.qkv_bias:
                for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                    put(lp[ours][i], f"{pre}self_attn.{hf}.bias")
    return params


def _flatten(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX pytree under the port's parameter names. A JAX int8 pair
    ``{"q", "s"}`` becomes ``name_q``/``name_s``, with ``q`` transposed from
    the JAX ``[in, out]`` to the port's ``[out, in]`` (the embedding is
    ``[V, E]`` in both)."""
    flat: Dict[str, Any] = {}

    def add(name: str, leaf: Any, transpose: bool) -> None:
        if isinstance(leaf, dict):
            q = np.asarray(leaf["q"])
            flat[f"{name}_q"] = np.swapaxes(q, -1, -2) if transpose else q
            flat[f"{name}_s"] = leaf["s"]
        else:
            flat[name] = leaf

    for k, v in tree.items():
        if k == "layers":
            for lk, lv in v.items():
                add(f"layers.{lk}", lv, True)
        else:
            add(k, v, k != "embed")
    return flat


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig, device="cpu") -> LlamaParams:
    """The JAX package's parameter pytree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as :class:`LlamaParams`; a tree
    from the JAX ``quantize_params_int8`` gives int8 params. Matrices take
    the config dtype (or stay int8), norms, biases and scales fp32."""
    int8 = isinstance(tree["layers"].get("wq"), dict)
    params = LlamaParams(config, torch.device(device), int8=int8)
    flat = _flatten(tree)
    named = dict(params.named_parameters())
    missing = set(named) - set(flat)
    if missing:
        raise KeyError(f"pytree lacks {sorted(missing)}")
    with torch.no_grad():
        for name, p in named.items():
            # a writable copy
            arr = np.array(flat[name], dtype=np.int8 if p.dtype == torch.int8 else np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return params
