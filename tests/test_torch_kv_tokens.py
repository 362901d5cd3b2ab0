"""The port's pure-Python XXH3-64 and block hashes are bit-equal to
``xxhash`` and to the JAX package's ``kv/tokens.py`` (prefix-cache identity
and KV events stay interchangeable between the two engines)."""

import random

import pytest
import xxhash

from dynamo_tpu.kv import tokens as jax_tokens
from dynamo_tpu_torch.kv import tokens as port_tokens


@pytest.mark.parametrize("seed", [0, 1337, (1 << 64) - 3])
def test_xxh3_bit_equal_all_lengths(seed):
    # 0..1024 bytes covers every length path (0, 1-3, 4-8, 9-16, 17-128,
    # 129-240, and the striped long path with a partial last block)
    rng = random.Random(seed & 0xFFFF)
    data = bytes(rng.randrange(256) for _ in range(1024 + 1100))
    for n in range(0, 1025):
        chunk = data[n: 2 * n]
        assert port_tokens.xxh3_64(chunk, seed) == xxhash.xxh3_64_intdigest(chunk, seed=seed), n
    long = data[:2100]  # two full 1024-byte blocks + tail
    assert port_tokens.xxh3_64(long, seed) == xxhash.xxh3_64_intdigest(long, seed=seed)


def test_block_hashes_match_jax_package():
    rng = random.Random(7)
    for n_tokens in range(0, 257, 3):
        toks = [rng.randrange(0, 200000) for _ in range(n_tokens)]
        for bs, salt in ((16, None), (4, b"tenant-a")):
            assert port_tokens.compute_block_hashes_for_seq(toks, bs, salt) == \
                jax_tokens.compute_block_hashes_for_seq(toks, bs, salt)
        assert port_tokens.compute_local_block_hash(toks) == \
            jax_tokens.compute_local_block_hash(toks)
        parent = rng.randrange(1 << 64)
        assert port_tokens.compute_block_hash(toks, parent) == \
            jax_tokens.compute_block_hash(toks, parent)


def test_token_block_sequence_matches_jax_package():
    toks = list(range(100, 171))
    a = port_tokens.TokenBlockSequence(toks[:30], block_size=8, salt=b"s")
    b = jax_tokens.TokenBlockSequence(toks[:30], block_size=8, salt=b"s")
    a.extend(toks[30:])
    b.extend(toks[30:])
    assert a.block_hashes() == b.block_hashes()
    assert [x.local_hash for x in a.blocks] == [x.local_hash for x in b.blocks]
    a.truncate(20)
    b.truncate(20)
    assert a.block_hashes() == b.block_hashes() and a.partial_tokens == b.partial_tokens
