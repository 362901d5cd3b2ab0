"""The port's sampling against the JAX package's on fixed logits: greedy
tokens equal, top-k/top-p keep-masks equal, penalties and logprobs allclose
(fp32, atol 1e-5), and per-seed determinism of the port's random draws
(``jax.random`` streams cannot be reproduced, so temperature > 0 is held to
determinism within the port and to staying inside the kept candidates)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine_jax import sampling as js
from dynamo_tpu_torch.engine_torch import sampling as ts


def _logits(seed=0, b=6, v=300):
    return np.random.default_rng(seed).normal(size=(b, v)).astype(np.float32) * 3


def test_candidates_match():
    assert ts.CANDIDATES == js.CANDIDATES


def test_greedy_equal():
    lg = _logits()
    b = lg.shape[0]
    zeros = np.zeros(b, np.float32)
    want = js.sample_tokens(jnp.asarray(lg), None, jnp.asarray(zeros), jnp.zeros(b, jnp.int32),
                            jnp.ones(b), greedy_only=True)
    got = ts.sample_tokens(torch.from_numpy(lg), torch.zeros(b), torch.zeros(b, dtype=torch.int32),
                           torch.ones(b), greedy_only=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # temperature 0 on the sampling path is greedy too
    got2 = ts.sample_tokens(torch.from_numpy(lg), torch.zeros(b), torch.zeros(b, dtype=torch.int32),
                            torch.ones(b), noise=ts.gumbel_noise([1] * b, [True] * b, 3, 0))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want))


def test_keep_mask_matches_jax_rule():
    lg = _logits(1)
    temp = np.array([0.7, 1.0, 1.3, 0.5, 1.0, 2.0], np.float32)
    top_k = np.array([0, 5, 64, 1, 10, 0], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.05], np.float32)
    c = js.CANDIDATES
    # the JAX sampler's mask, written out from sample_tokens
    scaled = jnp.asarray(lg) / jnp.maximum(jnp.asarray(temp), 1e-6)[:, None]
    top, _ = jax.lax.top_k(scaled, c)
    ranks = jnp.arange(c)[None, :]
    k_eff = jnp.where(top_k > 0, jnp.minimum(top_k, c), c)[:, None]
    probs = jax.nn.softmax(top, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    want = (ranks < k_eff) & ((cum - probs) < jnp.clip(top_p, 0.0, 1.0)[:, None])
    ttop, _ = torch.topk(torch.from_numpy(lg) / torch.from_numpy(temp)[:, None], c)
    got = ts.sample_keep_mask(ttop, torch.from_numpy(top_k), torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_tokens_stay_in_kept_set_and_are_seed_deterministic():
    lg = torch.from_numpy(_logits(2))
    b = lg.shape[0]
    temp = torch.full((b,), 0.8)
    top_k = torch.tensor([3, 3, 0, 0, 1, 8], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 0.2, 0.9, 1.0, 0.5])
    seeds = [11, 11, 12, 13, 14, 15]
    draws = []
    for _ in range(2):
        noise = ts.gumbel_noise(seeds, [True] * b, step=4, k=1)
        draws.append(ts.sample_tokens(lg, temp, top_k, top_p, noise=noise))
    assert torch.equal(draws[0], draws[1])  # same seed and step: same token
    noise = ts.gumbel_noise(seeds, [True] * b, step=4, k=1)
    assert torch.equal(noise[0], noise[1])  # the stream depends on the seed, not the lane
    assert not torch.equal(noise[1], noise[2])
    other = ts.sample_tokens(lg, temp, top_k, top_p,
                             noise=ts.gumbel_noise(seeds, [True] * b, step=5, k=1))
    top, idx = torch.topk(lg / temp[:, None], ts.CANDIDATES)
    keep = ts.sample_keep_mask(top, top_k, top_p)
    for tok in (draws[0], other):
        for i in range(b):
            kept = set(idx[i][keep[i]].tolist())
            assert int(tok[i]) in kept
    assert int(draws[0][4]) == int(lg[4].argmax())  # top_k=1


def test_penalties_and_counts_match():
    lg = _logits(3, b=3, v=20)
    counts = np.random.default_rng(3).integers(0, 3, size=(3, 20)).astype(np.int32)
    fp = np.array([0.5, 0.0, -1.0], np.float32)
    pp = np.array([0.0, 1.5, 0.25], np.float32)
    want = js.apply_penalties(jnp.asarray(lg), jnp.asarray(counts), jnp.asarray(fp), jnp.asarray(pp))
    got = ts.apply_penalties(torch.from_numpy(lg), torch.from_numpy(counts),
                             torch.from_numpy(fp), torch.from_numpy(pp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    toks = np.array([4, 4, 19], np.int32)
    active = np.array([True, False, True])
    want_c = js.update_counts(jnp.asarray(counts), jnp.asarray(toks), jnp.asarray(active))
    got_c = ts.update_counts(torch.from_numpy(counts.copy()), torch.from_numpy(toks),
                             torch.from_numpy(active))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_logprobs_allclose():
    lg = _logits(4)
    toks = np.array([0, 5, 17, 299, 3, 100], np.int32)
    w = js.token_logprobs(jnp.asarray(lg), jnp.asarray(toks), 5)
    g = ts.token_logprobs(torch.from_numpy(lg), torch.from_numpy(toks), 5)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
    np.testing.assert_allclose(g[2].numpy(), np.asarray(w[2]), atol=1e-5, rtol=0)
