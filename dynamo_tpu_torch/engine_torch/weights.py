"""Model config resolution and weights for the torch engine.

Maps an HF-layout model directory onto :class:`LlamaConfig`. A directory
without weight files gets deterministic random weights made on the device
(the JAX package's ``load_params`` behaviour for such a card);
:func:`params_from_numpy` carries the JAX package's parameter pytree across,
so both packages compute the same function in the tests. Reading
safetensors/GGUF files is later work (see ROADMAP.md).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Any, Dict

import numpy as np
import torch

from ..llm.model_card import ModelDeploymentCard
from ..models.llama import LlamaConfig, LlamaParams, init_params

logger = logging.getLogger(__name__)


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
    """Random-initialise on ``device`` when the card has no weight files."""
    if card.model_path and (
        glob.glob(os.path.join(card.model_path, "*.safetensors"))
        or glob.glob(os.path.join(card.model_path, "*.gguf"))
    ):
        raise NotImplementedError(
            f"{card.model_path}: loading weight files is not supported by the "
            "torch engine yet"
        )
    logger.info("no weight files for %s: random-initializing", card.display_name)
    return init_params(config, seed=seed, device=device)


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig, device="cpu") -> LlamaParams:
    """The JAX package's parameter pytree, its leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as :class:`LlamaParams`. Each
    leaf keeps its shape; matrices take the config dtype, norms/biases fp32."""
    params = LlamaParams(config, torch.device(device))
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    named = dict(params.named_parameters())
    missing = set(named) - set(flat)
    if missing:
        raise KeyError(f"pytree lacks {sorted(missing)}")
    with torch.no_grad():
        for name, p in named.items():
            arr = np.array(flat[name], dtype=np.float32)  # a writable copy
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return params
