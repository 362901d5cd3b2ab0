"""Model config resolution and weight loading for the torch engine.

Maps an HF-layout model directory onto :class:`LlamaConfig` and its weights
onto :class:`LlamaParams`, as the JAX package's ``engine_jax/weights.py``
does: a card with a ``gguf_path`` loads the GGUF file (``llm/gguf.py``), a
directory with ``*.safetensors`` files loads those (``safetensors.py``, the
port's own reader), and a directory without weight files gets deterministic
random weights made on the device. Tensors go to the device one at a time.
With ``int8`` (the ``"int8-all"`` mode) each matrix is quantized as it
reaches the card, so the bf16 tree never exists there: the way a model too
large for the card in bf16 (mixtral-8x7b) is served. The mixtral family's HF
names (``block_sparse_moe.gate`` and ``experts.{x}.w1/w3/w2``) load into the
router and the expert stacks. :func:`params_from_numpy` carries the JAX
package's parameter pytree across (its int8 tree too), so both packages
compute the same function in the tests.

With a tp ``mesh`` each tensor is sliced to its ranks as it is read (or,
for random weights, as each global matrix is drawn on rank 0's device), so
the whole tree never sits on one device; the result is a
:class:`ShardedParams`. With ``int8`` too, each whole matrix is quantized
first and its q and s are sliced after (a row-parallel matrix's scales need
its whole contracted axis); a mixtral checkpoint's experts arrive one
``[out, in]`` slice at a time, each sliced to the ranks' F/tp.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..llm.model_card import ModelDeploymentCard
from ..models.llama import (
    LlamaConfig,
    LlamaParams,
    ShardedParams,
    init_params,
    init_params_int8,
    quantize_matrix,
    quantize_params_int8,
    shard_params,
)
from ..parallel.mesh import Mesh
from .safetensors import hf_tensors

logger = logging.getLogger(__name__)

# HF module name of each stacked matrix (nn.Linear weights, [out, in])
_HF_MATS = {
    "wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}
# the mixtral family's expert matrices: block_sparse_moe.experts.{x}.<name>
_HF_EXPERTS = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}


def config_from_card(card: ModelDeploymentCard, dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Derive a LlamaConfig from the card's HF config.json contents."""
    mc = card.model_config or {}
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
        # mixtral family: sparse MoE MLP
        num_experts=int(mc.get("num_local_experts", 0) or 0),
        num_experts_per_tok=int(mc.get("num_experts_per_tok", 2)),
        dtype=dtype,
    )


def load_params(card: ModelDeploymentCard, config: LlamaConfig, seed: int = 0,
                device="cuda", int8: bool = False, mesh: Optional[Mesh] = None,
                ) -> Union[LlamaParams, ShardedParams]:
    """Load llama-family weights (GGUF or safetensors) onto ``device``, or
    random-initialise there when the card has no weight files. ``int8``
    gives the int8 tree of ``quantize_params_int8``, built without the bf16
    one from safetensors files or a seed (a GGUF file is read in bf16 and
    then quantized). ``mesh``: onto its ranks, sharded (module note); a
    GGUF file is read on the host and then sharded."""
    gguf_path = getattr(card, "gguf_path", None)
    if gguf_path:
        from ..llm.gguf import gguf_params, read_gguf

        params = gguf_params(read_gguf(gguf_path), config,
                             device="cpu" if mesh is not None else device)
        params = quantize_params_int8(params, config) if int8 else params
        return shard_params(params, config, mesh) if mesh is not None else params
    tensors = hf_tensors(card.model_path) if card.model_path else None
    if tensors is None:
        logger.info("no weight files for %s: random-initializing", card.display_name)
        init = init_params_int8 if int8 else init_params
        return init(config, seed=seed, device=device, mesh=mesh)
    return params_from_hf(tensors, config, device=device, int8=int8, mesh=mesh)


def params_from_hf(tensors: Mapping[str, Union[torch.Tensor, np.ndarray]], config: LlamaConfig,
                   device="cpu", int8: bool = False, mesh: Optional[Mesh] = None,
                   ) -> Union[LlamaParams, ShardedParams]:
    """HF llama/qwen2/mixtral naming → :class:`LlamaParams` on ``device``:
    ``[out, in]`` matrices transposed to ``[in, out]``, layers (and a
    mixtral layer's experts) stacked, the mixtral router
    ``block_sparse_moe.gate`` [X, E] transposed to ``[E, X]`` fp32, the
    qwen2 ``bq/bk/bv`` added and ``tie_word_embeddings`` honoured (no
    ``lm_head.weight`` is read). Norms, biases and the router are fp32,
    matrices the config dtype. Each tensor is copied to the device as
    stored, then converted there, one at a time. ``int8``: each matrix,
    converted to the config dtype, is quantized on the device as it
    arrives (HF ``[out, in]`` is already the int8 ``q`` layout), which
    gives ``quantize_params_int8`` of the bf16 tree bit for bit (on a
    ``mesh`` too: a whole matrix is quantized, then sliced)."""
    c = config
    if mesh is not None:
        params = ShardedParams.empty(c, mesh, int8=int8)
        dev = mesh.devices[0]
    else:
        params = LlamaParams(c, torch.device(device), int8=int8)
        dev = params.final_norm.device

    def fetch(name: str) -> torch.Tensor:
        t = tensors[name]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.to(dev)

    def put(ours: str, idx: tuple, name: str, transpose: bool = False) -> None:
        t = fetch(name)
        params.assign(ours, idx, t.T if transpose else t)

    def put_mat(ours: str, idx: tuple, name: str) -> None:
        """An HF [out, in] matrix into parameter ``ours`` (a name of
        ``param_shapes``) at ``idx``; the embedding [V, E] as it is."""
        embed = ours == "embed"
        if not int8:
            put(ours, idx, name, transpose=not embed)
            return
        w = fetch(name).to(c.dtype)
        q, s = quantize_matrix(w if embed else w.T, per_row=embed)
        params.assign(ours + "_q", idx, q)
        params.assign(ours + "_s", idx, s)

    with torch.no_grad():
        put_mat("embed", (), "model.embed_tokens.weight")
        put("final_norm", (), "model.norm.weight")
        if not c.tie_embeddings:
            put_mat("lm_head", (), "lm_head.weight")
        for i in range(c.num_layers):
            pre = f"model.layers.{i}."
            put("layers.attn_norm", (i,), pre + "input_layernorm.weight")
            put("layers.mlp_norm", (i,), pre + "post_attention_layernorm.weight")
            for ours, hf in _HF_MATS.items():
                if c.num_experts > 1 and ours in _HF_EXPERTS:
                    for x in range(c.num_experts):
                        put_mat(f"layers.{ours}", (i, x), f"{pre}block_sparse_moe.experts."
                                                          f"{x}.{_HF_EXPERTS[ours]}.weight")
                else:
                    put_mat(f"layers.{ours}", (i,), f"{pre}{hf}.weight")
            if c.num_experts > 1:
                put("layers.moe_router", (i,), pre + "block_sparse_moe.gate.weight",
                    transpose=True)
            if c.qkv_bias:
                for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                    put(f"layers.{ours}", (i,), f"{pre}self_attn.{hf}.bias")
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
