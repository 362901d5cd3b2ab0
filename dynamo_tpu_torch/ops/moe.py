"""Sparse mixture-of-experts MLP (the mixtral family's FFN).

Counterpart of the JAX package's ``ops/moe.py``: GShard/Switch-style top-k
routing with a static per-expert capacity, each expert's silu-gated FFN run
over its batch of routed tokens, and the outputs recombined with the router
weights. Tokens past an expert's capacity get nothing from that expert.

The JAX code forms the expert batches with one-hot dispatch and combine
einsums (``[N, X, C]``). Here both are index operations computing the same
function: dispatch gathers each routed token's row into its slot of
``[X, C, E]`` (empty slots are zero rows), and combine sums each token's at
most k slot outputs, weighted, in fp32, rounded once to x's dtype. Every
shape is fixed by (N, X, C), so nothing waits on the host.

The expert products are the only heavy work. A bf16 stack ``[X, in, out]``
goes through ``torch.bmm`` (the JAX package leaves it to XLA's einsum); an
int8 stack (:class:`Int8Weight` with ``q`` [X, out, in], ``s`` [X, out])
goes through the expert-batched W8A16 kernels
(``ops/int8_matmul.py::int8_expert_matmul``), one launch per stack: the
split-K kernel at decode capacities, the expert tile kernel for a prefill
chunk's.

**Tensor parallelism** (the JAX ``moe_param_logical_axes``: the FFN width
over tp): a tp rank holds every expert at F/tp, ``[X, E, F/tp]`` for
``w_gate``/``w_up`` and ``[X, F/tp, E]`` for ``w_down``, and the router
whole. Its hidden states are the replicated ones after ``all_reduce``, so
every rank routes alike and fills the same slots. ``moe_mlp(...,
partial=True)`` returns the rank's share of the output: the weighted
combine of its ``w_down`` outputs, summed in fp32 and left unrounded, which
``all_reduce`` sums over the ranks and rounds once. The combine is linear in
the ``w_down`` output, so the sum of the partials is the unsharded
combine, but for where each side rounds: a bf16 stack's ``w_down`` output
stays fp32 on a rank (``torch.bmm`` with an fp32 output), where the
unsharded layer rounds it to bf16 before the combine; an int8 stack rounds
``x @ q.T`` to x's dtype on each rank over its slice of F (the W8A16
function, as the dense ``matw_partial`` does), then scales it in fp32.

Expert parallelism (the ``experts`` axis over ep) waits for the port's ep
(ROADMAP A7); ``init_moe_params`` and router noise (training only) are not
ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from .int8_matmul import Int8Weight, int8_expert_matmul

Weight = Union[torch.Tensor, Int8Weight]


@dataclass(frozen=True)
class MoeConfig:
    hidden_size: int
    intermediate_size: int  # per-expert FFN width
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert token capacity for an n_tokens batch (padding
        included)."""
        c = math.ceil(n_tokens * self.top_k / self.num_experts * self.capacity_factor)
        return max(self.top_k, c)


def _expert_mat(x: torch.Tensor, w: Weight, out_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """[X, C, in] against an expert stack: a bf16 ``[X, in, out]`` tensor,
    or an int8 pair (``matw``'s contract per expert: the product rounded to
    x's dtype, times the fp32 scale, rounded again; on the card the kernel
    that :func:`plan_int8` takes for (X, C, out, in)). [X, C, out] in
    ``out_dtype`` (default x's): fp32 leaves a bf16 product unrounded and an
    int8 one unrounded after its scale."""
    if isinstance(w, Int8Weight):
        return int8_expert_matmul(x.contiguous(), w.q, w.s, out_dtype=out_dtype)
    if out_dtype in (None, x.dtype):
        return torch.bmm(x, w)
    if x.device.type == "cuda":
        return torch.bmm(x, w, out_dtype=out_dtype)
    return torch.bmm(x.to(out_dtype), w.to(out_dtype))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, equal values in order of index (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, cfg: MoeConfig, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router in fp32: (probs [N, X], top_p [N, K] renormalized over
    the chosen experts, top_idx [N, K])."""
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = top_k(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_p, top_idx


def moe_mlp(
    params: Dict[str, Weight], cfg: MoeConfig,
    x: torch.Tensor,  # [B, T, E]
    *, token_valid: Optional[torch.Tensor] = None,  # [B, T] bool; None = all valid
    with_aux: bool = True, partial: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sparse MoE FFN: (output [B, T, E], aux) with aux's
    ``load_balancing_loss`` and ``dropped_fraction`` over valid tokens.
    ``params``: ``router`` [E, X] fp32, ``w_gate``/``w_up`` [X, E, F] and
    ``w_down`` [X, F, E] (or int8 pairs of them). ``token_valid`` masks
    padding out of routing, so that it claims no expert capacity.
    ``with_aux=False`` (serving) skips the aux terms and returns ``{}``: an
    eager step would launch their kernels for nothing, where XLA drops the
    unused outputs. ``partial``: a tp rank's share (stacks at F/tp), fp32
    and unrounded (module note)."""
    b, t, e = x.shape
    n = b * t
    xe, k = cfg.num_experts, cfg.top_k
    cap = cfg.capacity(n)
    xt = x.reshape(n, e)
    probs, top_p, top_idx = route(params["router"], cfg, xt)

    # each (token, choice)'s arrival index at its expert: k-major, all first
    # choices before all second choices, padding claiming no slot
    onehot = torch.nn.functional.one_hot(top_idx, xe)  # [N, K, X]
    if token_valid is not None:
        onehot = onehot * token_valid.reshape(n, 1, 1).to(onehot.dtype)
    prio = onehot.transpose(0, 1).reshape(k * n, xe)
    pos = (torch.cumsum(prio, dim=0) - prio).reshape(k, n, xe).transpose(0, 1)
    within = (pos < cap) & (onehot > 0)  # [N, K, X]
    routed = within.any(dim=-1)  # [N, K]
    slot = pos.gather(-1, top_idx[..., None])[..., 0]  # [N, K]
    # flat slot expert·C + slot; X·C (one past the last) = nowhere
    flat = torch.where(routed, top_idx * cap + slot, torch.full_like(slot, xe * cap))

    # dispatch: the token in each slot ([X·C] token indices, n = none), its
    # row gathered; slots no token reached read the zero row
    src = torch.full((xe * cap + 1,), n, dtype=torch.long, device=x.device)
    tokens = torch.arange(n, device=x.device)[:, None].expand(n, k)
    src.scatter_(0, flat.reshape(-1), tokens.reshape(-1))
    x_pad = torch.cat([xt, xt.new_zeros((1, e))])
    expert_in = x_pad[src[: xe * cap]].reshape(xe, cap, e)

    gate = torch.nn.functional.silu(_expert_mat(expert_in, params["w_gate"]).float()).to(x.dtype)
    up = _expert_mat(expert_in, params["w_up"])
    # [X, C, E]; a tp rank's partial stays fp32
    expert_out = _expert_mat(gate * up, params["w_down"], torch.float32 if partial else None)

    # combine: each token's routed slots, weighted by the router weight in
    # x's dtype, summed in fp32 and rounded once (a partial: left in fp32)
    out_pad = torch.cat([expert_out.reshape(xe * cap, e), expert_out.new_zeros((1, e))])
    weight = torch.where(routed, top_p, torch.zeros_like(top_p)).to(x.dtype)
    out = (weight.float()[..., None] * out_pad[flat].float()).sum(dim=1)
    out = out if partial else out.to(x.dtype)
    if not with_aux:
        return out.reshape(b, t, e), {}

    # GShard aux loss: mean fraction routed x mean router prob per expert,
    # over valid tokens only
    frac_n = onehot.sum(dim=1).float()  # [N, X]
    routed_f = routed.float()
    if token_valid is not None:
        vf = token_valid.reshape(n).float()
        nv = vf.sum().clamp(min=1.0)
        frac = frac_n.sum(dim=0) / nv
        imp = (probs * vf[:, None]).sum(dim=0) / nv
        dropped = 1.0 - (routed_f * vf[:, None]).sum() / (nv * k)
    else:
        frac = frac_n.mean(dim=0)
        imp = probs.mean(dim=0)
        dropped = 1.0 - routed_f.mean()
    aux = {"load_balancing_loss": (frac * imp).sum() * xe, "dropped_fraction": dropped}
    return out.reshape(b, t, e), aux


def moe_mlp_reference(params: Dict[str, torch.Tensor], cfg: MoeConfig,
                      x: torch.Tensor) -> torch.Tensor:
    """Dense per-token reference (no capacity, no drops) for parity tests:
    every expert on every token, then each token's exact top-k mixture.
    Takes plain (not int8) expert stacks."""
    b, t, e = x.shape
    xt = x.reshape(-1, e)
    _, top_p, top_idx = route(params["router"], cfg, xt)
    gate = torch.nn.functional.silu(
        torch.einsum("ne,xef->nxf", xt, params["w_gate"]).float()).to(x.dtype)
    up = torch.einsum("ne,xef->nxf", xt, params["w_up"])
    all_out = torch.einsum("nxf,xfe->nxe", gate * up, params["w_down"])  # [N, X, E]
    sel = all_out.gather(1, top_idx[..., None].expand(-1, -1, e))  # [N, K, E]
    out = (sel * top_p[..., None].to(x.dtype)).sum(dim=1)
    return out.reshape(b, t, e)
