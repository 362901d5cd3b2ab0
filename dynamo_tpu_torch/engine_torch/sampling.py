"""Token sampling on the device: greedy / temperature / top-k / top-p, per slot.

Counterpart of the JAX package's ``engine_jax/sampling.py``. Sampling runs
beside the step so only token ids cross to the host. top-k and top-p act on
the top ``CANDIDATES`` logits (a partial sort), exactly as in the JAX sampler.

Random draws: ``jax.random`` streams cannot be reproduced in PyTorch. The
draw is a Gumbel-max over the kept candidates with noise that the caller
supplies (:func:`gumbel_noise` derives it from a per-lane
``torch.Generator`` seeded by the request seed and the step), so with
temperature > 0 the contract is per-seed determinism within this port: the
same seed at the same engine step gives the same token. Greedy decoding
(temperature <= 0) is exact and equals the JAX engine's.

Encoding of "disabled": temperature <= 0 → greedy; top_k <= 0 → no top-k;
top_p >= 1 → no top-p.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# static candidate budget for top-k/top-p (the preprocessor clamps top_k to it)
CANDIDATES = 64


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    counts: torch.Tensor,  # [B, V] int — output-token occurrence counts
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,  # [B]
) -> torch.Tensor:
    """OpenAI-semantics repetition penalties over output token counts:
    ``logit[t] -= freq * count[t] + presence * (count[t] > 0)``."""
    cf = counts.float()
    return (
        logits
        - frequency_penalty[:, None] * cf
        - presence_penalty[:, None] * (cf > 0).float()
    )


def update_counts(
    counts: torch.Tensor,  # [B, V] int32
    tokens: torch.Tensor,  # [B] sampled this step
    active: torch.Tensor,  # [B] bool — lanes whose sample is real
) -> torch.Tensor:
    """Add this step's sampled tokens into the count buffer (in place)."""
    b = counts.shape[0]
    rows = torch.arange(b, device=counts.device)
    counts.index_put_((rows, tokens.long()), active.to(counts.dtype), accumulate=True)
    return counts


def _seed_for(seed: int, step: int, k: int) -> int:
    """Mix (request seed, dispatch step, step within the dispatch) into a
    63-bit generator seed (splitmix64 finalizer)."""
    x = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + k + 1) & ((1 << 64) - 1)
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def gumbel_noise(
    seeds: Sequence[int], sampled: Sequence[bool], step: int, k: int,
    n: int = CANDIDATES, device="cpu",
) -> torch.Tensor:
    """[B, n] Gumbel noise; row i comes from a CPU generator seeded by
    (seeds[i], step, k), zeros for lanes that do not sample. A CUDA
    ``device`` gets it through pinned memory without waiting for the
    stream (the step functions call this between their launches)."""
    out = torch.zeros((len(seeds), n), dtype=torch.float32)
    for i, (s, on) in enumerate(zip(seeds, sampled)):
        if on:
            g = torch.Generator().manual_seed(_seed_for(int(s), step, k))
            u = torch.rand(n, generator=g, dtype=torch.float32).clamp_(1e-20, 1.0 - 1e-7)
            out[i] = -torch.log(-torch.log(u))
    if torch.device(device).type == "cuda":
        return out.pin_memory().to(device, non_blocking=True)
    return out.to(device)


def sample_keep_mask(
    top_logits: torch.Tensor,  # [B, C] descending, temperature-scaled
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Which of the sorted candidates survive top-k and top-p."""
    c = top_logits.shape[-1]
    ranks = torch.arange(c, device=top_logits.device)[None, :]
    k_eff = torch.where(top_k > 0, top_k.clamp(max=c), torch.full_like(top_k, c))[:, None]
    keep_k = ranks < k_eff
    probs = torch.softmax(top_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p.clamp(0.0, 1.0)[:, None]
    return keep_k & keep_p


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int
    top_p: torch.Tensor,  # [B]
    *,
    noise: Optional[torch.Tensor] = None,  # [B, CANDIDATES] Gumbel noise
    greedy_only: bool = False,
) -> torch.Tensor:
    """Sample one token per row; returns [B] int32. ``greedy_only`` skips
    the candidate block when no lane samples."""
    greedy = torch.argmax(logits, dim=-1)
    if greedy_only:
        return greedy.to(torch.int32)
    b, v = logits.shape
    c = min(CANDIDATES, v)
    scaled = logits / temperature.clamp(min=1e-6)[:, None]
    top_logits, top_idx = torch.topk(scaled, c, dim=-1)  # sorted descending
    keep = sample_keep_mask(top_logits, top_k, top_p)
    masked = top_logits.masked_fill(~keep, float("-inf"))
    if noise is None:
        noise = torch.zeros((b, c), device=logits.device)
    choice = torch.argmax(masked + noise[:, :c], dim=-1)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def speculative_targets(
    logits_all: torch.Tensor,  # [B, K1, V] f32, one row per fed position
    counts: torch.Tensor,  # [B, V] int32 penalty counts (dummy when unused)
    active: torch.Tensor,  # [B, K1] bool: position actually fed (not padding)
    seeds: Sequence[int],  # [B] per-request seeds (host)
    sampled: Sequence[bool],  # [B] lanes that sample (host: temperature > 0)
    step: int,  # the dispatch's step counter
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,  # [B]
    *,
    with_pen: bool,
    with_sample: bool,
    with_lp: bool,
    n_top: int = 0,
) -> tuple:
    """Target tokens of a speculative-verify dispatch, position by position
    (the JAX ``speculative_targets``).

    The verify dispatch feeds ``[last_token, draft_0, .., draft_{k-1}]``
    through one forward pass; this samples the engine's OWN next token at
    every fed position: the token the sequential sampler would produce
    given the same prefix and the same per-position noise. Position j draws
    its noise as the j-th step of a decode window does
    (``gumbel_noise(seeds, .., step, j)``). The engine keeps the drafted
    prefix that MATCHES these targets plus the first non-matching target
    (the bonus token): every emitted token was drawn from the model's
    conditional at its position, and greedy output equals non-speculative
    greedy decode.

    Penalties are sequentially exact along the positions: the count buffer
    (updated in place) takes each position's target before the next is
    scored. Rejected positions do add their targets too; the engine
    subtracts exactly the non-emitted ones after the dispatch.

    Returns ``(targets [B, K1], counts)`` plus, with ``with_lp``,
    ``(chosen_lp [B, K1], top_ids [B, K1, n_top], top_lps [B, K1, n_top])``
    inserted before ``counts``.
    """
    k1 = logits_all.shape[1]
    outs, lps, tids, tlps = [], [], [], []
    for j in range(k1):
        sel = logits_all[:, j]
        noise = (
            gumbel_noise(seeds, sampled, step, j, device=logits_all.device)
            if with_sample else None
        )
        sampled_from = (
            apply_penalties(sel, counts, frequency_penalty, presence_penalty)
            if with_pen else sel
        )
        nxt = sample_tokens(sampled_from, temperature, top_k, top_p, noise=noise,
                            greedy_only=not with_sample)
        if with_pen:
            update_counts(counts, nxt, active[:, j])
        if with_lp:
            lp, ti, tl = token_logprobs(sel, nxt, n_top)
            lps.append(lp)
            tids.append(ti)
            tlps.append(tl)
        outs.append(nxt)
    out = torch.stack(outs, dim=1)
    if with_lp:
        return out, torch.stack(lps, 1), torch.stack(tids, 1), torch.stack(tlps, 1), counts
    return out, counts


def token_logprobs(
    logits: torch.Tensor,  # [B, V] float32 (raw, temperature-unscaled)
    tokens: torch.Tensor,  # [B]
    n_top: int,
):
    """(chosen_lp [B], top_ids [B, n_top] int32, top_lps [B, n_top]) of the
    raw model distribution."""
    b = logits.shape[0]
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    if n_top > 0:
        top_vals, top_ids = torch.topk(logits, n_top, dim=-1)
        top_lps = top_vals - lse[:, None]
    else:
        top_ids = torch.zeros((b, 0), dtype=torch.int32, device=logits.device)
        top_lps = torch.zeros((b, 0), dtype=torch.float32, device=logits.device)
    return chosen - lse, top_ids.to(torch.int32), top_lps
