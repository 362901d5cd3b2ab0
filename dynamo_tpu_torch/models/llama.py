"""Llama-family decoder in PyTorch over a paged KV cache.

Counterpart of the JAX package's ``models/llama.py``. The parameters live in
an ``nn.Module`` (:class:`LlamaParams`) that holds the same stacked
``[L, in, out]`` tensors as the JAX pytree, so weights carry over 1:1
(``engine_torch/weights.py``). The layer loop is a Python loop over the
stacked leading axis (the JAX package scans it).

The mixtral family (``num_experts > 1``) replaces the dense FFN by the
sparse MoE layer of ``ops/moe.py`` in every path (:func:`mlp_partial`), with
expert stacks ``[L, X, in, out]`` and a router ``[L, E, X]`` in fp32.

Weight-only int8 (the JAX ``quantize_params_int8``, ``matw``, int8
``embed_lookup`` and ``lm_head``): :func:`quantize_params_int8` gives a
:class:`LlamaParams` whose matrices are :class:`Int8Weight` pairs, ``q`` int8
and ``s`` fp32 per output channel. :func:`init_params_int8` makes the same
int8 tree from a seed without the bf16 one ever existing (the fit mode of a
model too large for the card in bf16: mixtral-8x7b, llama3-70b), onto a tp
mesh too. **Layout:** ``q`` is
``[..., out, in]`` with K contiguous, the transpose of the JAX ``[in, out]``
``q`` (and of the port's own bf16 matrices): the natural operand of a
small-M kernel, and the layout of the embedding ``[V, E]``, so the tied LM
head (per-row scales) is one more weight of the same kind. ``engine_torch/weights.py`` transposes a
JAX int8 tree on the way in. Every int8 product goes through
``ops/int8_matmul.py`` (the CUDA kernels on the card; an expert stack in
one launch).

The KV cache is ``{"k": [L, N, bs, KVH, D], "v": ...}`` (the JAX layout) and
is updated in place. Decode history always goes through the paged flash-decode
kernel (``ops/paged_attention.py``); the JAX package's dense history tier is
not ported (its choice was tuned on a TPU). An int8 pool
(``make_kv_cache(..., quantized=True)``, the JAX layout and key names) adds
``k_scale``/``v_scale`` ``[L, N, bs]`` fp32, one absmax scale per token slot;
fresh K/V are quantized per token as they are written (a prefill chunk's
before its scatter, a decode window once at its flush), and decode reads the
pool through the int8 paged kernel.

**Tensor parallelism** (the JAX ``param_shardings`` Megatron layout over a
tp mesh, ``parallel/mesh.py``): :func:`shard_params` gives each rank a
:class:`LlamaParams` of the per-rank config (:func:`rank_config`: H/tp,
KVH/tp, F/tp, V/tp; an MoE model's every expert at F/tp) on its device, as
a :class:`ShardedParams`; rank ``r`` holds exactly JAX's addressable shard
``r``, of the bf16 tree or of the int8 one. The pool is a list of per-rank
pools ``[L, N, bs, KVH/tp, D]`` (:func:`make_kv_cache` with ``mesh``).
Every forward takes either kind: on a mesh q/k/v and gate/up are
column-parallel, ``wo`` and ``w_down`` row-parallel with their partials
(an MoE layer's: the weighted combine of the rank's ``w_down`` outputs,
``ops/moe.py``) summed by ``all_reduce`` before the residual, the embedding lookup
vocab-parallel (each rank its own rows, the others masked, then
``all_reduce``), the LM head column-parallel over vocab with the logits
gathered on rank 0's device; decode attention is the paged kernel per
rank (``paged_decode_attention_sharded``). An unsharded call is the one-rank
case, whose collectives are the identity. Inputs and outputs of a forward
live on rank 0's device.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch import nn

from ..ops.attention import (
    dequantize_kv,
    gather_pages,
    paged_attention,
    quantize_kv,
    write_kv_to_pages,
)
from ..ops.int8_matmul import Int8Weight, int8_weight_matmul
from ..ops.moe import MoeConfig, moe_mlp
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_sharded,
    per_rank_attention,
)
from ..parallel.collectives import all_gather, all_reduce
from ..parallel.mesh import Mesh, Sharding, logical_to_sharding

# {"k": [L,N,bs,KVH,D], "v": ...}, and for an int8 pool "k_scale"/"v_scale" [L,N,bs]
KVCache = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qkv_bias: bool = False  # qwen2-family attention biases
    # sparse MoE MLP (mixtral family): > 1 routes every path's MLP block
    # through ops/moe.py; 0/1 = dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 2.0  # serving: generous, rare drops
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


LLAMA_PRESETS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
    ),
    "llama3.2-1b": LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_layers=16,
        num_heads=32, num_kv_heads=8, head_dim=64, tie_embeddings=True,
    ),
    "llama3-8b": LlamaConfig(),
    "llama3-70b": LlamaConfig(
        hidden_size=8192, intermediate_size=28672, num_layers=80,
        num_heads=64, num_kv_heads=8, head_dim=128,
    ),
    "qwen2.5-7b": LlamaConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
        rope_theta=1000000.0, rms_norm_eps=1e-6, qkv_bias=True,
    ),
    "qwen2.5-1.5b": LlamaConfig(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_layers=28, num_heads=12, num_kv_heads=2, head_dim=128,
        rope_theta=1000000.0, rms_norm_eps=1e-6, qkv_bias=True,
        tie_embeddings=True,
    ),
    # mixtral family: llama attention + sparse MoE MLP
    "tiny-moe": LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
        num_experts=4, num_experts_per_tok=2,
    ),
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, num_experts=8, num_experts_per_tok=2,
    ),
}


# -- params ------------------------------------------------------------------

Weight = Union[torch.Tensor, Int8Weight]
# the dense matrices of a layer, quantized by quantize_params_int8
INT8_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def param_shapes(c: LlamaConfig, int8: bool = False
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name → (shape, dtype); ``layers.*`` are stacked over L (and MoE
    expert stacks over L, X). With ``int8`` each matrix ``name`` is
    ``name_q`` [..., out, in] int8 plus ``name_s`` [..., out] fp32 (the
    embedding per row, the LM head per vocab entry); the MoE router stays
    fp32 ``[L, E, X]``."""
    L, E, F, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    f32 = torch.float32
    ffn = (L, c.num_experts) if c.num_experts > 1 else (L,)  # MoE: expert stacks
    mats = {
        "embed": (V, E),
        "layers.wq": (L, E, c.q_dim),
        "layers.wk": (L, E, c.kv_dim),
        "layers.wv": (L, E, c.kv_dim),
        "layers.wo": (L, c.q_dim, E),
        "layers.w_gate": ffn + (E, F),
        "layers.w_up": ffn + (E, F),
        "layers.w_down": ffn + (F, E),
    }
    if not c.tie_embeddings:
        mats["lm_head"] = (E, V)
    shapes = {"final_norm": ((E,), f32), "layers.attn_norm": ((L, E), f32),
              "layers.mlp_norm": ((L, E), f32)}
    if c.num_experts > 1:
        shapes["layers.moe_router"] = ((L, E, c.num_experts), f32)
    for name, shape in mats.items():
        if not int8:
            shapes[name] = (shape, c.dtype)
        elif name == "embed":
            shapes["embed_q"], shapes["embed_s"] = (shape, torch.int8), ((V,), f32)
        else:  # [..., in, out] -> q [..., out, in], s [..., out]
            out_in = shape[:-2] + (shape[-1], shape[-2])
            shapes[f"{name}_q"], shapes[f"{name}_s"] = (out_in, torch.int8), (out_in[:-1], f32)
    if c.qkv_bias:
        shapes["layers.bq"] = ((L, c.q_dim), f32)
        shapes["layers.bk"] = ((L, c.kv_dim), f32)
        shapes["layers.bv"] = ((L, c.kv_dim), f32)
    return shapes


class LlamaParams(nn.Module):
    """The stacked parameter set: ``embed``, ``final_norm``, ``lm_head``
    (untied) and ``layers[name]`` with a leading layer axis. Norm weights
    and biases are fp32, matrices the config dtype (the JAX dtypes), or
    int8 pairs when ``int8`` (see :func:`param_shapes`)."""

    def __init__(self, config: LlamaConfig, device: torch.device, int8: bool = False):
        super().__init__()
        self.config = config
        self.int8 = int8
        self.layers = nn.ParameterDict()
        for name, (shape, dt) in param_shapes(config, int8).items():
            p = nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)
            if name.startswith("layers."):
                self.layers[name[len("layers."):]] = p
            else:
                self.register_parameter(name, p)
        self._layer_mats = INT8_MATS if int8 else ()
        self._layer_plain = [k for k in self.layers
                             if not (int8 and k[:-2] in INT8_MATS)]

    def weight(self, name: str) -> Weight:
        """``embed`` or ``lm_head``: a tensor, or an :class:`Int8Weight`."""
        if self.int8:
            return Int8Weight(getattr(self, f"{name}_q"), getattr(self, f"{name}_s"))
        return getattr(self, name)

    def layer(self, i: int) -> Dict[str, Weight]:
        """One layer's tensors (leading axis removed): views, no copies;
        an int8 matrix is an :class:`Int8Weight` of views."""
        lp: Dict[str, Weight] = {k: self.layers[k][i] for k in self._layer_plain}
        for k in self._layer_mats:
            lp[k] = Int8Weight(self.layers[f"{k}_q"][i], self.layers[f"{k}_s"][i])
        return lp

    def assign(self, name: str, idx: tuple, w: torch.Tensor) -> None:
        """Copy ``w`` into parameter ``name`` (of :func:`param_shapes`) at
        the leading index ``idx``."""
        self.get_parameter(name)[idx].copy_(w)


# -- tensor parallelism ------------------------------------------------------

def param_logical_axes(config: LlamaConfig, int8: bool = False
                       ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical sharding axes per parameter of :func:`param_shapes` (the JAX
    ``param_logical_axes``, and for ``int8`` its ``quantized_logical_axes``
    in the port's layout: ``q`` [..., out, in] takes the matrix's axes with
    the last two swapped, ``s`` drops the contracted ``in`` axis; the
    embedding's ``q`` keeps ``(vocab, embed)`` and its ``s`` ``(vocab,)``)."""
    ffn = ("layers", "experts") if config.num_experts > 1 else ("layers",)
    mats = {
        "embed": ("vocab", "embed"),
        "layers.wq": ("layers", "embed", "heads"),
        "layers.wk": ("layers", "embed", "kv_heads"),
        "layers.wv": ("layers", "embed", "kv_heads"),
        "layers.wo": ("layers", "heads", "embed"),
        "layers.w_gate": ffn + ("embed", "mlp"),
        "layers.w_up": ffn + ("embed", "mlp"),
        "layers.w_down": ffn + ("mlp", "embed"),
    }
    if not config.tie_embeddings:
        mats["lm_head"] = ("embed", "vocab")
    axes: Dict[str, Tuple[Optional[str], ...]] = {
        "final_norm": ("embed",), "layers.attn_norm": ("layers", "embed"),
        "layers.mlp_norm": ("layers", "embed"),
    }
    if config.num_experts > 1:
        axes["layers.moe_router"] = ("layers", "embed", None)
    for name, ax in mats.items():
        if not int8:
            axes[name] = ax
        elif name == "embed":
            axes["embed_q"], axes["embed_s"] = ax, ax[:1]
        else:
            axes[f"{name}_q"] = ax[:-2] + (ax[-1], ax[-2])
            axes[f"{name}_s"] = ax[:-2] + (ax[-1],)
    if config.qkv_bias:
        axes["layers.bq"] = ("layers", "heads")
        axes["layers.bk"] = ("layers", "kv_heads")
        axes["layers.bv"] = ("layers", "kv_heads")
    return axes


def rank_config(config: LlamaConfig, tp: int) -> LlamaConfig:
    """The config whose shapes one of ``tp`` ranks holds: H/tp, KVH/tp,
    F/tp and V/tp. An MoE model keeps every expert on each rank (the
    ``experts`` axis follows ep, which a mesh holds at 1) with each
    expert's FFN width at F/tp, as the JAX ``moe_param_logical_axes``
    shard it over tp. Heads that do not split over tp raise (ROADMAP A11;
    the JAX package falls back to its GSPMD jnp path there)."""
    if tp == 1:
        return config
    c = config
    if c.num_heads % tp or c.num_kv_heads % tp:
        raise ValueError(f"{c.num_heads} query and {c.num_kv_heads} kv heads do not split "
                         f"evenly over tp={tp} (ROADMAP A11)")
    for name, n in (("intermediate_size", c.intermediate_size), ("vocab_size", c.vocab_size)):
        if n % tp:
            raise ValueError(f"{name} {n} does not split evenly over tp={tp}")
    return dataclasses.replace(c, num_heads=c.num_heads // tp,
                               num_kv_heads=c.num_kv_heads // tp,
                               intermediate_size=c.intermediate_size // tp,
                               vocab_size=c.vocab_size // tp)


class ShardedParams:
    """A model's parameters over a tp mesh: ``shards[r]`` is rank r's
    :class:`LlamaParams` (the shapes of :func:`rank_config`) on
    ``mesh.devices[r]``; ``config`` is the whole model's. Norms are
    replicated, every other leaf split as :func:`param_logical_axes` says."""

    def __init__(self, config: LlamaConfig, mesh: Mesh, shards: List[LlamaParams]):
        self.config = config
        self.mesh = mesh
        self.shards = shards
        self.int8 = shards[0].int8
        axes = param_logical_axes(config, self.int8)
        self.rules: Dict[str, Sharding] = {
            n: logical_to_sharding(mesh, *ax) for n, ax in axes.items()}

    @classmethod
    def empty(cls, config: LlamaConfig, mesh: Mesh, int8: bool = False) -> "ShardedParams":
        rc = rank_config(config, mesh.tp)
        return cls(config, mesh, [LlamaParams(rc, d, int8=int8) for d in mesh.devices])

    def assign(self, name: str, idx: tuple, w: torch.Tensor) -> None:
        """Each rank's slice of the whole leaf ``name`` at leading index
        ``idx`` (``w`` = the leaf's ``[idx]``), copied onto its device."""
        rule = self.rules[name]
        if rule.dim is not None:
            if rule.dim < len(idx):
                raise ValueError(f"{name}: the index {idx} cuts the split dimension")
            rule = Sharding(rule.dim - len(idx), rule.parts)
        for r, shard in enumerate(self.shards):
            shard.assign(name, idx, rule.shard(w, r))


def shard_params(params: LlamaParams, config: LlamaConfig, mesh: Mesh) -> ShardedParams:
    """Rank r's slice of every leaf on ``mesh.devices[r]``: JAX's
    addressable shard r of ``jax.device_put(params, param_shardings(...))``
    (an int8 tree: of ``quantized_param_shardings``), leaf by leaf."""
    out = ShardedParams.empty(config, mesh, int8=params.int8)
    with torch.no_grad():
        for name, p in params.named_parameters():
            out.assign(name, (), p)
    return out


def _split(params, config: LlamaConfig
           ) -> Tuple[List[LlamaParams], List[LlamaConfig], Optional[Mesh]]:
    """(each rank's params, each rank's config, the mesh): a
    :class:`ShardedParams`'s ranks, or the one rank of a :class:`LlamaParams`
    under ``config``."""
    if isinstance(params, ShardedParams):
        return params.shards, [p.config for p in params.shards], params.mesh
    return [params], [config], None


# A dense model's layer matrices are drawn whole, stacked over the layers,
# while the largest of them takes at most this many bytes in fp32
WHOLE_DRAW_MAX_BYTES = 16 << 30


def draws_whole(c: LlamaConfig) -> bool:
    """The draw rule of :func:`_random_slices`, from the config alone, so
    that an unsharded model and a tp model from one seed hold equal
    weights: a dense model whose largest stacked layer matrix takes at most
    ``WHOLE_DRAW_MAX_BYTES`` (16 GiB) in fp32 draws each matrix whole,
    stacked over its layers (llama3-8b's ``w_gate`` [32, 4096, 14336] is
    7.5 GB: the draws of every earlier measurement); any other model draws
    one ``[in, out]`` layer or expert slice at a time (llama3-70b's
    ``w_gate`` [80, 8192, 28672] would be 75.2 GB; every MoE model)."""
    if c.num_experts > 1:
        return False
    shapes = param_shapes(c)
    largest = max(math.prod(shapes[f"layers.{m}"][0]) for m in INT8_MATS)
    return 4 * largest <= WHOLE_DRAW_MAX_BYTES


def _random_slices(c: LlamaConfig, seed: int, device: torch.device
                   ) -> Iterator[Tuple[str, Tuple[int, ...], torch.Tensor]]:
    """The random matrices of :func:`init_params` in a fixed order (the
    embedding and LM head, then the layers' matrices): (name in
    :func:`param_shapes`, index into its leading axes, the draw as normal /
    sqrt(fan_in) in fp32, cast to the parameter's dtype). The embedding and
    LM head are drawn whole; the layers' matrices whole or one slice at a
    time as :func:`draws_whole` says. Each fp32 draw is freed when it is
    cast, so beside the parameters only one draw in the parameter's dtype
    exists at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = param_shapes(c)
    whole_layers = draws_whole(c)
    for name in sorted(shapes, key=lambda n: n.startswith("layers.")):  # stable
        shape, dt = shapes[name]
        leaf = name.split(".")[-1]
        if leaf.endswith("norm") or leaf in ("bq", "bk", "bv"):
            continue
        whole = whole_layers or leaf in ("embed", "lm_head")
        lead = () if whole else shape[:-2]
        fan_in = shape[-1] if leaf == "embed" else shape[-2]
        for idx in itertools.product(*map(range, lead)):
            w = torch.randn(shape[len(lead):], generator=gen, device=device,
                            dtype=torch.float32)
            w = w.div_(math.sqrt(fan_in)).to(dt)
            yield name, idx, w


def _fill_constants(params: "LlamaParams") -> None:
    """Norm weights 1, biases 0."""
    for name, p in params.named_parameters():
        leaf = name.split(".")[-1]
        if leaf.endswith("norm"):
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            p.zero_()


def _draw_into(params, config: LlamaConfig, seed: int, device: torch.device,
               int8: bool) -> None:
    """Fill ``params`` (a :class:`LlamaParams`, or a :class:`ShardedParams`
    whose ``assign`` slices each leaf to its ranks) with the draws of
    :func:`_random_slices` made on ``device``; ``int8`` quantizes each
    ``[in, out]`` matrix of a draw whole, then assigns its q and s."""
    with torch.no_grad():
        for shard in getattr(params, "shards", [params]):
            _fill_constants(shard)
        for name, idx, w in _random_slices(config, seed, device):
            if not int8 or name.endswith("moe_router"):
                params.assign(name, idx, w)
                continue
            per_row = name == "embed"
            for sub in itertools.product(*map(range, () if per_row else w.shape[:-2])):
                q, s = quantize_matrix(w[sub], per_row=per_row)
                params.assign(name + "_q", idx + sub, q)
                params.assign(name + "_s", idx + sub, s)
                del q, s


def init_params(config: LlamaConfig, seed: int = 0, device="cpu",
                mesh: Optional[Mesh] = None) -> Union[LlamaParams, ShardedParams]:
    """Random init with fan-in scaling (normal / sqrt(fan_in)), drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` (whole
    matrices or one slice at a time: :func:`draws_whole`); norms are 1 and
    biases 0. Streams differ from ``jax.random``'s: carry JAX weights over
    with ``weights.params_from_numpy`` where equality matters. With
    ``mesh`` the same global draws are made on rank 0's device and each is
    sharded over the ranks as it is drawn, so a tp model and an unsharded
    one from one seed on one device hold the same weights."""
    if mesh is not None:
        params = ShardedParams.empty(config, mesh)
        _draw_into(params, config, seed, mesh.devices[0], int8=False)
        return params
    device = torch.device(device)
    params = LlamaParams(config, device)
    _draw_into(params, config, seed, device, int8=False)
    return params


def init_params_int8(config: LlamaConfig, seed: int = 0, device="cpu",
                     mesh: Optional[Mesh] = None) -> Union[LlamaParams, ShardedParams]:
    """``quantize_params_int8(init_params(config, seed, device), config)``,
    bit for bit, without the bf16 tree: the same draws in the same order,
    each quantized one ``[in, out]`` matrix at a time as it is drawn. Beside
    the int8 tree only one draw exists at a time (one slice, or one stacked
    matrix of a model that :func:`draws_whole`), and the quantization works
    over slices of whole output channels (:func:`_quantize`). With ``mesh``
    each global matrix is drawn and quantized whole on rank 0's device,
    then its q and s are sharded (a row-parallel matrix's scales need its
    whole contracted axis): ``shard_params(init_params_int8(config, seed,
    device), config, mesh)`` bit for bit, without the whole int8 tree on
    any one device."""
    if mesh is not None:
        params = ShardedParams.empty(config, mesh, int8=True)
        _draw_into(params, config, seed, mesh.devices[0], int8=True)
        return params
    device = torch.device(device)
    params = LlamaParams(config, device, int8=True)
    _draw_into(params, config, seed, device, int8=True)
    return params


def make_kv_cache(
    config: LlamaConfig, num_blocks: int, block_size: int,
    dtype: Optional[torch.dtype] = None, device="cpu", quantized: bool = False,
    mesh: Optional[Mesh] = None,
) -> Union[KVCache, List[KVCache]]:
    """Allocate the paged KV pool: [layers, blocks, block_size, kv_heads, head_dim].

    ``quantized=True`` is the JAX int8 page layout: int8 ``k``/``v`` and
    per-token scale tables ``k_scale``/``v_scale`` [layers, blocks,
    block_size] float32, grouped by physical block so that the scales
    travel with their pages (prefix reuse, the host tier).

    With ``mesh``: one pool per rank on its device, its kv heads the rank's
    slice of the global ones (``kv_cache_sharding``), each contiguous, as
    the paged kernel takes it. Int8 pages on a mesh raise, as in the JAX
    engine."""
    if mesh is not None:
        if quantized:
            raise ValueError("kv_dtype='int8' requires an unsharded cache (mesh=None); "
                             "sharded engines keep the native KV dtype")
        rc = rank_config(config, mesh.tp)
        return [make_kv_cache(rc, num_blocks, block_size, dtype, device=d) for d in mesh.devices]
    c = config
    shape = (c.num_layers, num_blocks, block_size, c.num_kv_heads, c.head_dim)
    if quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    dt = dtype or c.dtype
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def kv_cache_quantized(kv_cache: KVCache) -> bool:
    """Is this pool the int8 page layout?"""
    return "k_scale" in kv_cache


def _layer_pool(kv_cache: KVCache, i: int) -> Tuple[torch.Tensor, ...]:
    """Layer ``i``'s pages: (k, v), and for an int8 pool (k, v, k_scale,
    v_scale). Views, no copies."""
    names = ("k", "v", "k_scale", "v_scale") if kv_cache_quantized(kv_cache) else ("k", "v")
    return tuple(kv_cache[n][i] for n in names)


def _write_pool(pool: Tuple[torch.Tensor, ...], k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, block_tables: torch.Tensor) -> None:
    """Scatter fresh K/V into one layer's pages (in place); an int8 pool
    takes them quantized per token, and the scales go through the same index
    math (the scatter is trailing-dim agnostic)."""
    if len(pool) == 4:
        kq, vq, ks, vs = quantize_kv(k, v)
        write_kv_to_pages(pool[0], pool[1], kq, vq, positions, block_tables)
        write_kv_to_pages(pool[2], pool[3], ks, vs, positions, block_tables)
    else:
        write_kv_to_pages(pool[0], pool[1], k, v, positions, block_tables)


# the weights of one quantization pass (fp32 temporaries of 256 MB), so that
# the embedding and LM head of a large vocabulary quantize beside a card
# that their model nearly fills (llama3-70b in "int8-all")
_QUANT_CHUNK = 1 << 26


def _quantize(w: torch.Tensor, contract_dim: int, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax/127 int8 along ``contract_dim``: (q in w's layout, s).
    ``amax``: the absmax to scale by (a row-parallel shard's: that of the
    whole contracted axis), else w's own. Works over slices of whole output
    channels of about ``_QUANT_CHUNK`` weights each, which is exact: each
    channel's scale is its own."""
    axis = w.dim() - 2 if contract_dim == w.dim() - 1 else w.dim() - 1  # output channels
    s_axis = axis - (axis > contract_dim)
    n = w.shape[axis]
    step = max(1, _QUANT_CHUNK * n // max(w.numel(), 1))
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:contract_dim] + w.shape[contract_dim + 1:], dtype=torch.float32,
                    device=w.device)
    for a in range(0, n, step):
        b = min(n, a + step)
        wf = w.narrow(axis, a, b - a).to(torch.float32, copy=True)
        am = wf.abs().amax(dim=contract_dim) if amax is None else amax.narrow(s_axis, a, b - a)
        sc = (am / 127.0).clamp(min=1e-12)
        # half to even, as jnp.round; the clamped integers convert exactly
        q.narrow(axis, a, b - a).copy_(wf.div_(sc.unsqueeze(contract_dim)).round_()
                                       .clamp_(-127, 127))
        s.narrow(s_axis, a, b - a).copy_(sc)
        del wf
    return q, s


def quantize_matrix(w: torch.Tensor, per_row: bool = False,
                    amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One matrix (or stack) in the JAX layout ``[..., in, out]`` to the
    port's int8 pair: contracted over ``in`` (the JAX rule "ndim - 2"), ``q``
    transposed to ``[..., out, in]``. ``per_row``: the embedding ``[V, E]``,
    quantized per row and kept as it is. ``amax`` scales by a given absmax
    (see :func:`_quantize`)."""
    if per_row:
        return _quantize(w, 1, amax)
    q, s = _quantize(w, w.dim() - 2, amax)
    return q.transpose(-1, -2), s


def quantize_params_int8(params, config: LlamaConfig):
    """Every dense matrix to int8 with per-output-channel absmax/127 scales
    (``max(absmax / 127, 1e-12)``, ``q = clip(round(w / s), -127, 127)``),
    the embedding per row and each expert of an MoE stack on its own; norms,
    biases and the MoE router are shared with ``params``. The JAX
    ``quantize_params_int8`` in the port's ``[out, in]`` layout. Works one
    layer at a time on the params' device. :class:`ShardedParams` give the
    sharded int8 tree of the whole one (:func:`_quantize_sharded`)."""
    if isinstance(params, ShardedParams):
        return _quantize_sharded(params, config)
    if params.int8:
        raise ValueError("params are already quantized")
    dev = params.final_norm.device
    out = LlamaParams(config, dev, int8=True)
    with torch.no_grad():
        out.final_norm = params.final_norm
        for k, v in params.layers.items():
            if k not in INT8_MATS:
                out.layers[k] = v
        q, s = quantize_matrix(params.embed, per_row=True)
        out.embed_q.copy_(q)
        out.embed_s.copy_(s)
        if not config.tie_embeddings:
            q, s = quantize_matrix(params.lm_head)
            out.lm_head_q.copy_(q)
            out.lm_head_s.copy_(s)
        del q, s
        for name in INT8_MATS:
            for i in range(config.num_layers):
                q, s = quantize_matrix(params.layers[name][i])
                out.layers[f"{name}_q"][i].copy_(q)
                out.layers[f"{name}_s"][i].copy_(s)
    return out


def _quantize_sharded(params: ShardedParams, config: LlamaConfig) -> ShardedParams:
    """``shard_params(quantize_params_int8(whole tree))`` bit for bit,
    without the whole tree: a column-parallel shard holds whole output
    channels and is quantized alone; a row-parallel shard (``wo``,
    ``w_down``: the contracted ``in`` axis split) is scaled by the absmax of
    the whole axis, the max of the ranks' absmaxes, so its scales are the
    whole matrix's on every rank, never recomputed over the rank's slice."""
    if params.int8:
        raise ValueError("params are already quantized")
    mesh = params.mesh
    out = ShardedParams.empty(config, mesh, int8=True)
    dev0 = mesh.devices[0]

    def quantized(name: str, ws: List[torch.Tensor], per_row: bool = False):
        # ws: the ranks' [in, out] slices of one matrix (a layer's: the
        # leaf's leading layer axis taken off the rule's dimension)
        split = params.rules[name].dim
        lead = 1 if name.startswith("layers.") else 0
        if not per_row and split is not None and split - lead == ws[0].dim() - 2:
            amax = torch.stack([w.float().abs().amax(dim=-2).to(dev0) for w in ws]).amax(dim=0)
            return [quantize_matrix(w, amax=amax.to(w.device)) for w in ws]
        return [quantize_matrix(w, per_row=per_row) for w in ws]

    with torch.no_grad():
        for src, dst in zip(params.shards, out.shards):
            dst.final_norm = src.final_norm
            for k, v in src.layers.items():
                if k not in INT8_MATS:
                    dst.layers[k] = v
        heads = [("embed", True)] + ([] if config.tie_embeddings else [("lm_head", False)])
        for name, per_row in heads:
            for dst, (q, s) in zip(out.shards, quantized(
                    name, [getattr(p, name) for p in params.shards], per_row)):
                getattr(dst, f"{name}_q").copy_(q)
                getattr(dst, f"{name}_s").copy_(s)
        for name in INT8_MATS:
            for i in range(config.num_layers):
                ws = [p.layers[name][i] for p in params.shards]
                for dst, (q, s) in zip(out.shards, quantized(f"layers.{name}", ws)):
                    dst.layers[f"{name}_q"][i].copy_(q)
                    dst.layers[f"{name}_s"][i].copy_(s)
    return out


# -- math --------------------------------------------------------------------

def matw(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``x @ w`` for a plain ``[in, out]`` matrix; for an
    :class:`Int8Weight` the W8A16 product in x's dtype (the JAX ``matw``:
    the product rounded to x's dtype, times the fp32 scales, rounded
    again), through the int8 kernel on the card."""
    if isinstance(w, Int8Weight):
        return int8_weight_matmul(x.contiguous(), w.q, w.s)
    return x @ w


def matw_partial(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """:func:`matw` as a row-parallel rank's partial: the same product left
    in fp32, unrounded, for ``all_reduce`` to sum and round once (a bf16
    partial rounded per rank, then summed, would add a rounding the
    unsharded product lacks). Plain weights: fp32 accumulation of the
    products of x and w as given (cuBLAS with an fp32 output on the card);
    an :class:`Int8Weight`: the W8A16 product with its fp32 epilogue, ``x @
    q.T`` rounded to x's dtype as :func:`matw` rounds it, times the scales,
    not rounded again."""
    if isinstance(w, Int8Weight):
        return int8_weight_matmul(x.contiguous(), w.q, w.s, out_dtype=torch.float32)
    if x.dtype == torch.float32:
        return x @ w
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split rotation; x: [B, T, H, D], positions: [B, T]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions.clamp(min=0).float()[..., None] * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def embed_lookup(params: LlamaParams, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-table gather; an int8 table dequantizes its rows (fp32
    product, then the config dtype)."""
    rows = tokens.clamp(min=0).long()
    e = params.weight("embed")
    if isinstance(e, Int8Weight):
        return (e.q[rows].float() * e.s[rows][..., None]).to(params.config.dtype)
    return e[rows]


def project_qkv(
    lp: Dict[str, torch.Tensor], c: LlamaConfig, hidden: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-norm, Q/K/V projections (+ qwen2 biases), head reshape, rope."""
    b, t = positions.shape
    x = rms_norm(hidden, lp["attn_norm"], c.rms_norm_eps)
    q, k, v = matw(x, lp["wq"]), matw(x, lp["wk"]), matw(x, lp["wv"])
    if c.qkv_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    q = q.reshape(b, t, c.num_heads, c.head_dim)
    k = k.reshape(b, t, c.num_kv_heads, c.head_dim)
    v = v.reshape(b, t, c.num_kv_heads, c.head_dim)
    q = apply_rope(q, positions, c.rope_theta)
    k = apply_rope(k, positions, c.rope_theta)
    return q, k, v


def moe_config(c: LlamaConfig) -> MoeConfig:
    """The MoE layer's configuration of a mixtral-family model."""
    return MoeConfig(hidden_size=c.hidden_size, intermediate_size=c.intermediate_size,
                     num_experts=c.num_experts, top_k=c.num_experts_per_tok,
                     capacity_factor=c.expert_capacity_factor)


def mlp_partial(lp: Dict[str, Weight], c: LlamaConfig, hidden: torch.Tensor,
                positions: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """Post-norm FFN without the residual: dense silu-gated, or the sparse
    MoE layer (``ops/moe.py``) when the config declares experts.
    ``partial``: a tp rank's row-parallel partial, fp32 and unrounded (of
    ``w_down``; of an MoE layer, the weighted combine of the rank's
    ``w_down`` outputs).
    ``positions`` (< 0 = padding) masks padding out of MoE routing, so that
    it claims no expert capacity ahead of real tokens."""
    x = rms_norm(hidden, lp["mlp_norm"], c.rms_norm_eps)
    if c.num_experts > 1:
        moe_params = {"router": lp["moe_router"], "w_gate": lp["w_gate"],
                      "w_up": lp["w_up"], "w_down": lp["w_down"]}
        out, _ = moe_mlp(moe_params, moe_config(c), x, token_valid=positions >= 0,
                         with_aux=False, partial=partial)
        return out if partial else out.to(hidden.dtype)
    gate = torch.nn.functional.silu(matw(x, lp["w_gate"]).float()).to(x.dtype)
    return (matw_partial if partial else matw)(gate * matw(x, lp["w_up"]), lp["w_down"])


def lm_head(params, config: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    """Project final hidden states to vocabulary logits (float32). An int8
    head (tied: the per-row embedding) is the W8A16 product with an fp32
    epilogue: ``float(round(h @ q.T)) * s``. :class:`ShardedParams`: each
    rank's vocab columns, gathered on rank 0's device."""
    if isinstance(params, ShardedParams):
        hs = params.mesh.replicate(h)
        return all_gather([lm_head(p, p.config, x) for p, x in zip(params.shards, hs)])
    head = params.weight("embed" if config.tie_embeddings else "lm_head")
    if isinstance(head, Int8Weight):
        return int8_weight_matmul(h.contiguous(), head.q, head.s, out_dtype=torch.float32)
    if config.tie_embeddings:
        head = head.T
    return (h @ head).float()


def _merge(num_a, m_a, l_a, num_b, m_b, l_b):
    """Flash-decoding combine of two unnormalized partials (rows in m/l's
    shape, numerators with a trailing D)."""
    m_t = torch.maximum(m_a, m_b)
    a_a = torch.exp(m_a - m_t)
    a_b = torch.exp(m_b - m_t)
    den = a_a * l_a + a_b * l_b
    num = num_a * a_a[..., None] + num_b * a_b[..., None]
    out = num / den.clamp(min=1e-30)[..., None]
    return torch.where((den > 0)[..., None], out, torch.zeros_like(out))


# -- forward -----------------------------------------------------------------

def _replicate(mesh: Optional[Mesh], *ts: torch.Tensor) -> List[List[torch.Tensor]]:
    """Each tensor on every rank's device ([t] alone without a mesh)."""
    return [[t] if mesh is None else mesh.replicate(t) for t in ts]


def _embed_ranks(shards: List[LlamaParams], mesh: Optional[Mesh],
                 tokens: List[torch.Tensor]) -> List[torch.Tensor]:
    """The embedding lookup on each rank: unsharded, the plain lookup;
    vocab-parallel on a mesh, each rank's own rows with the others' tokens
    masked to zero, summed by ``all_reduce`` (exact: one nonzero term)."""
    if mesh is None:
        return [embed_lookup(shards[0], tokens[0])]
    parts = []
    for r, (p, t) in enumerate(zip(shards, tokens)):
        v = p.config.vocab_size
        local = t.clamp(min=0).long() - r * v
        mine = (local >= 0) & (local < v)
        e = embed_lookup(p, torch.where(mine, local, torch.zeros_like(local)))
        parts.append(torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype,
                                                                  device=e.device)))
    return all_reduce(parts)


def _residual(hs: List[torch.Tensor], parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The residual stream plus a row-parallel product: the ranks' partials
    summed and rounded once to the stream's dtype (``all_reduce``; the
    identity for one rank), added on each rank."""
    return [h + o for h, o in zip(hs, all_reduce(parts, hs[0].dtype))]


def _final(shards: List[LlamaParams], cfgs: List[LlamaConfig], hs: List[torch.Tensor],
           hidden_only: bool) -> torch.Tensor:
    """Final norm, then the hidden states (rank 0's) or the logits
    (gathered over the vocab shards on rank 0's device)."""
    hs = [rms_norm(h, p.final_norm, c.rms_norm_eps) for h, p, c in zip(hs, shards, cfgs)]
    if hidden_only:
        return hs[0]
    return all_gather([lm_head(p, c, h) for p, c, h in zip(shards, cfgs, hs)])


def _pools(kv_cache, n: int) -> List[KVCache]:
    pools = kv_cache if isinstance(kv_cache, list) else [kv_cache]
    if len(pools) != n:
        raise ValueError(f"{len(pools)} KV pools for {n} ranks")
    return pools


def _attention_partial(lp, c: LlamaConfig, hidden, positions, k_page, v_page,
                       block_tables, partial: bool = False) -> torch.Tensor:
    """A layer's attention in :func:`forward` up to ``wo`` (``partial``: a
    tp rank's row-parallel partial, :func:`matw_partial`): writes this
    step's K/V into the layer's pages (in place) and attends through the
    block tables."""
    b, t = positions.shape
    q, k, v = project_qkv(lp, c, hidden, positions)
    write_kv_to_pages(k_page, v_page, k, v, positions, block_tables)
    attn = paged_attention(q, k_page, v_page, block_tables, positions)
    return (matw_partial if partial else matw)(attn.reshape(b, t, c.q_dim), lp["wo"])


def forward(
    params, config: LlamaConfig,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]; < 0 = padding
    kv_cache, block_tables: torch.Tensor,
    *, hidden_only: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """One forward step (prefill if T>1, decode if T==1): writes new K/V into
    the paged cache, attends through block tables, returns (logits [B, T,
    vocab] float32, cache). ``params`` a :class:`ShardedParams` and
    ``kv_cache`` its per-rank pools: the tp forward (module note)."""
    shards, cfgs, mesh = _split(params, config)
    ranks, tp = range(len(shards)), mesh is not None
    pools = _pools(kv_cache, len(shards))
    toks, pos, tables = _replicate(mesh, tokens, positions, block_tables)
    hs = _embed_ranks(shards, mesh, toks)
    for i in range(config.num_layers):
        lps = [p.layer(i) for p in shards]
        hs = _residual(hs, [
            _attention_partial(lps[r], cfgs[r], hs[r], pos[r], pools[r]["k"][i],
                               pools[r]["v"][i], tables[r], tp) for r in ranks])
        hs = _residual(hs, [mlp_partial(lps[r], cfgs[r], hs[r], pos[r], tp) for r in ranks])
    return _final(shards, cfgs, hs, hidden_only), kv_cache


def _history_partial(q, gk, gv, chunk_start, q_positions, scale):
    """Flash partial of chunk queries against pre-chunk paged history:
    (numerator [B,T,H,D] f32, row max [B,H,T], denom [B,H,T])."""
    b, t, h, d = q.shape
    kvh = gk.shape[2]
    g = h // kvh
    smax = gk.shape[1]
    qg = q.reshape(b, t, kvh, g, d).float()
    scores = torch.einsum("btngd,bsnd->bngts", qg, gk.float()) * scale
    kv_pos = torch.arange(smax, device=q.device)[None, :]
    mask = (kv_pos < chunk_start[:, None])[:, None, None, None, :]
    mask = mask & (q_positions >= 0)[:, None, None, :, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1).clamp(min=-1e30)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bngts,bsnd->btngd", p, gv.float())
    return num.reshape(b, t, h, d), m.reshape(b, h, t), l.reshape(b, h, t)


def _chunk_self_partial(q, k, v, positions, scale):
    """Flash partial of chunk queries against the chunk's own keys (causal
    by position)."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, t, kvh, g, d).float()
    scores = torch.einsum("btngd,bsnd->bngts", qg, k.float()) * scale
    causal = positions[:, None, :] <= positions[:, :, None]
    valid = (positions >= 0)[:, :, None] & (positions >= 0)[:, None, :]
    mask = (causal & valid)[:, None, None, :, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1).clamp(min=-1e30)
    p = torch.exp(scores - m[..., None])
    num = torch.einsum("bngts,bsnd->btngd", p, v.float())
    return num.reshape(b, t, h, d), m.reshape(b, h, t), p.sum(dim=-1).reshape(b, h, t)


def _chunk_attention(c: LlamaConfig, q, k, v, pool, block_tables, chunk_start, positions,
                     with_history: bool, dtype) -> torch.Tensor:
    """A prefill chunk's attention on one rank: the flash merge of the
    in-chunk causal partial (over the exact fresh K/V, an int8 pool or not)
    with the partial over pool history (positions < each lane's chunk
    start, untouched by this chunk's scatter either way; an int8 pool
    dequantizes the gathered lanes only). [B, T, H, D] f32."""
    scale = c.head_dim ** -0.5
    num, m, l = _chunk_self_partial(q, k, v, positions, scale)
    if not with_history:
        den = l.transpose(1, 2)[..., None]
        return torch.where(den > 0, num / den.clamp(min=1e-30), torch.zeros_like(num))
    gk, gv = (gather_pages(x, block_tables) for x in pool[:2])
    if len(pool) == 4:
        gk = dequantize_kv(gk, gather_pages(pool[2], block_tables), dtype)
        gv = dequantize_kv(gv, gather_pages(pool[3], block_tables), dtype)
    num_h, m_h, l_h = _history_partial(q, gk, gv, chunk_start, positions, scale)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731  [B,H,T] → [B,T,H]
    return _merge(num_h, tr(m_h), tr(l_h), num, tr(m), tr(l))


def forward_chunk(
    params, config: LlamaConfig,
    tokens: torch.Tensor,  # [B, C]
    positions: torch.Tensor,  # [B, C]; < 0 = padding
    kv_cache, block_tables: torch.Tensor,
    *, hidden_only: bool = False, with_history: bool = True,
    layer_hook: Optional[Callable[[], None]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill-chunk forward: attention is the flash merge of a partial over
    pool history (positions < each lane's chunk start) with an in-chunk
    causal partial over the fresh K/V in hand; the chunk's K/V are written
    into the pages for later chunks and decode. ``with_history=False``
    skips the history partial (every lane starts at position 0). On a tp
    mesh each rank attends its own heads over its own pool (module note).
    ``layer_hook`` is called after each layer's work is enqueued (the
    device timer's segment boundaries)."""
    shards, cfgs, mesh = _split(params, config)
    ranks, tp = range(len(shards)), mesh is not None
    matw_wo = matw_partial if tp else matw
    pools = _pools(kv_cache, len(shards))
    toks, pos, tables = _replicate(mesh, tokens, positions, block_tables)
    hs = _embed_ranks(shards, mesh, toks)
    chunk_start = [torch.where(p[:, 0] >= 0, p[:, 0], 0) for p in pos]
    b, t = positions.shape
    for i in range(config.num_layers):
        lps = [p.layer(i) for p in shards]
        parts = []
        for r in ranks:
            c, pool = cfgs[r], _layer_pool(pools[r], i)
            q, k, v = project_qkv(lps[r], c, hs[r], pos[r])
            attn = _chunk_attention(c, q, k, v, pool, tables[r], chunk_start[r], pos[r],
                                    with_history, hs[r].dtype)
            _write_pool(pool, k, v, pos[r], tables[r])
            parts.append(matw_wo(attn.to(hs[r].dtype).reshape(b, t, c.q_dim), lps[r]["wo"]))
        hs = _residual(hs, parts)
        hs = _residual(hs, [mlp_partial(lps[r], cfgs[r], hs[r], pos[r], tp) for r in ranks])
        if layer_hook is not None:
            layer_hook()
    return _final(shards, cfgs, hs, hidden_only), kv_cache


def _window_only_attention(c, q, base, wk, wv, wslot):
    """Flash attention over just the decode window: the unnormalized
    numerator [B, H, D] f32 plus row max / denominator [B, H] f32."""
    b, _, h_, d = q.shape
    kvh = c.num_kv_heads
    w = wk.shape[1]
    g = h_ // kvh
    qg = q.reshape(b, kvh, g, d).float()
    mask = (torch.arange(w, device=q.device)[None, :] <= wslot) & (base[:, None] >= 0)
    scores = torch.einsum("bngd,bwnd->bngw", qg, wk.float()) * (d ** -0.5)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1).clamp(min=-1e30)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    # the JAX einsum runs in the window dtype and is cast up after
    num = torch.einsum("bngw,bwnd->bngd", p.to(wv.dtype), wv).float()
    return num.reshape(b, h_, d), m.reshape(b, h_), l.reshape(b, h_)


def _merge_pool_window(c, q, o_p, m_p, l_p, base, wk, wv, wslot):
    """The pool partial of the paged kernel (o, m, l) merged with the
    window's partial by the flash-decoding combine: [B, 1, H, D]."""
    num_w, m_w, l_w = _window_only_attention(c, q, base, wk, wv, wslot)
    m_p = m_p.clamp(min=-1e30)
    m_t = torch.maximum(m_p, m_w)
    a_p = torch.exp(m_p - m_t) * l_p
    a_w = torch.exp(m_w - m_t)
    denom = a_p + a_w * l_w
    num = o_p.float() * a_p[..., None] + num_w * a_w[..., None]
    out = num / denom.clamp(min=1e-30)[..., None]
    out = torch.where((denom > 0)[..., None], out, torch.zeros_like(out))
    return out.to(q.dtype)[:, None]  # [B, 1, H, D]


def forward_window(
    params, config: LlamaConfig,
    tokens: torch.Tensor,  # [B] one token per lane
    positions: torch.Tensor,  # [B]; < 0 = padding
    kv_cache, block_tables: torch.Tensor,
    base: torch.Tensor,  # [B] pool holds positions < base
    window_k,  # [L, B, W, KVH, D] (on a mesh: one per rank, its KVH/tp heads)
    window_v,
    wslot: int,  # window slot of this step
    *, decode_attention=None, layer_hook: Optional[Callable[[], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over the read-only pool plus the window of fresh K/V
    (the JAX ``forward_window`` in its paged history mode).

    The step's K/V go into ``window_k/v[:, :, wslot]`` (in place), in the
    compute dtype for an int8 pool too; the engine flushes the window into
    the pages once per dispatch (:func:`flush_window`). ``decode_attention``
    is the pool-attention function: by default the kernel's wrapper,
    :func:`paged_decode_attention` or, for an int8 pool,
    :func:`paged_decode_attention_int8`; a caller may pass a plain version
    to compare the two. On a tp mesh every rank's pool partial comes from
    one call of :func:`paged_decode_attention_sharded` (the kernel per rank),
    or of ``decode_attention`` per rank when one is given. ``layer_hook`` is
    called after each layer's work is enqueued (the device timer's segment
    boundaries). Returns (logits [B, vocab] f32, window_k, window_v)."""
    shards, cfgs, mesh = _split(params, config)
    ranks, tp = range(len(shards)), mesh is not None
    matw_wo = matw_partial if tp else matw
    pools = _pools(kv_cache, len(shards))
    wks = window_k if isinstance(window_k, list) else [window_k]
    wvs = window_v if isinstance(window_v, list) else [window_v]
    if decode_attention is None and mesh is None:
        decode_attention = (paged_decode_attention_int8 if kv_cache_quantized(pools[0])
                            else paged_decode_attention)
    toks, pos, tables, bases = _replicate(mesh, tokens, positions, block_tables, base)
    hs = [e[:, None] for e in _embed_ranks(shards, mesh, toks)]  # [B, 1, E]
    pos2 = [p[:, None] for p in pos]
    lengths = [x.clamp(min=0).to(torch.int32) for x in bases]
    b = tokens.shape[0]
    for i in range(config.num_layers):
        lps = [p.layer(i) for p in shards]
        qs = []
        for r in ranks:
            q, k, v = project_qkv(lps[r], cfgs[r], hs[r], pos2[r])
            wks[r][i][:, wslot] = k[:, 0]
            wvs[r][i][:, wslot] = v[:, 0]
            qs.append(q)
        if mesh is None:
            stats = [decode_attention(qs[0][:, 0].contiguous(), *_layer_pool(pools[0], i),
                                      tables[0], lengths[0], return_stats=True)]
        else:
            args = ([q[:, 0].contiguous() for q in qs], [pl["k"][i] for pl in pools],
                    [pl["v"][i] for pl in pools], tables[0], lengths[0])
            if decode_attention is None:
                o, m, l = paged_decode_attention_sharded(*args, mesh=mesh, return_stats=True)
            else:
                o, m, l = per_rank_attention(decode_attention, *args, mesh=mesh,
                                             return_stats=True)
            stats = list(zip(o, m, l))
        parts = []
        for r in ranks:
            c = cfgs[r]
            attn = _merge_pool_window(c, qs[r], *stats[r], bases[r], wks[r][i], wvs[r][i],
                                      wslot)
            parts.append(matw_wo(attn.reshape(b, 1, c.q_dim), lps[r]["wo"]))
        hs = _residual(hs, parts)
        hs = _residual(hs, [mlp_partial(lps[r], cfgs[r], hs[r], pos2[r], tp) for r in ranks])
        if layer_hook is not None:
            layer_hook()
    return _final(shards, cfgs, hs, False)[:, 0], window_k, window_v


def flush_window(
    kv_cache, block_tables: torch.Tensor,
    base: torch.Tensor,  # [B] first position written by this dispatch
    window_k,  # [L, B, W, KVH, D] (on a mesh: one per rank)
    window_v, max_pos: int,
    layer_hook: Optional[Callable[[], None]] = None,
):
    """Scatter a decode dispatch's window into the paged pool (in place), one
    scatter per layer per dispatch; an int8 pool takes the window quantized
    per token, values and scales through the same scatter. Padding lanes
    (base < 0) and positions past ``max_pos`` are dropped. On a mesh each
    rank's window goes into its own pool. ``layer_hook`` is called after
    each layer's scatter is enqueued."""
    wks = window_k if isinstance(window_k, list) else [window_k]
    wvs = window_v if isinstance(window_v, list) else [window_v]
    pools = _pools(kv_cache, len(wks))
    w = wks[0].shape[2]
    fpos = base[:, None] + torch.arange(w, device=base.device)[None, :]
    valid = (base[:, None] >= 0) & (fpos <= max_pos)
    fpos = torch.where(valid, fpos, torch.full_like(fpos, -1))
    for pool, wk, wv in zip(pools, wks, wvs):
        dev = wk.device
        fp, tables = (x if x.device == dev else x.to(dev) for x in (fpos, block_tables))
        for i in range(wk.shape[0]):
            _write_pool(_layer_pool(pool, i), wk[i], wv[i], fp, tables)
            if layer_hook is not None:
                layer_hook()
    return kv_cache
