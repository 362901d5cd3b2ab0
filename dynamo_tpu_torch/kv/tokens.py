"""Sequence-aware chained block hashing over token ids.

The content-addressing scheme for KV-cache blocks: the allocator keys its
prefix cache on these hashes, and KV events carry them to the router. The
scheme is the JAX package's (``dynamo_tpu/kv/tokens.py``) bit for bit, so the
two engines' prefix-cache identities and events are interchangeable:

- tokens are serialized as little-endian u32
- ``local_hash  = xxh3_64(token_bytes, seed=SEED)``
- ``sequence_hash = xxh3_64(parent_sequence_hash_le8 || token_bytes, seed=SEED)``

XXH3-64 is implemented here in pure Python (every length path of the
reference algorithm, including the seeded custom secret of the long-input
path), so the port needs no ``xxhash`` package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

BLOCK_HASH_SEED = 1337

_M64 = (1 << 64) - 1
_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX1 = 0x165667919E3779F9
_PMX2 = 0x9FB21C651E98DF25

_SECRET = bytes((
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c, 0xf7, 0x21, 0xad, 0x1c,
    0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb, 0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f,
    0xcb, 0x79, 0xe6, 0x4e, 0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6, 0x81, 0x3a, 0x26, 0x4c,
    0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb, 0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3,
    0x71, 0x64, 0x48, 0x97, 0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7, 0xc7, 0x0b, 0x4f, 0x1d,
    0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31, 0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64,
    0xea, 0xc5, 0xac, 0x83, 0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26, 0x29, 0xd4, 0x68, 0x9e,
    0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc, 0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce,
    0x45, 0xcb, 0x3a, 0x8f, 0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
))


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, length: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * _PMX2) & _M64
    h ^= (h >> 35) + length
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _mix16(data: bytes, i: int, sec: bytes, j: int, seed: int) -> int:
    lo = _r64(data, i) ^ ((_r64(sec, j) + seed) & _M64)
    hi = _r64(data, i + 8) ^ ((_r64(sec, j + 8) - seed) & _M64)
    return _fold64(lo, hi)


def _hash_long(data: bytes, seed: int) -> int:
    if seed:
        sec = bytearray(len(_SECRET))
        for i in range(0, len(_SECRET), 16):
            sec[i:i + 8] = ((_r64(_SECRET, i) + seed) & _M64).to_bytes(8, "little")
            sec[i + 8:i + 16] = ((_r64(_SECRET, i + 8) - seed) & _M64).to_bytes(8, "little")
        sec = bytes(sec)
    else:
        sec = _SECRET
    n = len(data)
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    stripes_per_block = (len(sec) - 64) // 8
    block_len = 64 * stripes_per_block

    def accumulate_512(off: int, soff: int) -> None:
        for i in range(8):
            v = _r64(data, off + 8 * i)
            k = v ^ _r64(sec, soff + 8 * i)
            acc[i ^ 1] = (acc[i ^ 1] + v) & _M64
            acc[i] = (acc[i] + (k & 0xFFFFFFFF) * (k >> 32)) & _M64

    nb_blocks = (n - 1) // block_len
    for b in range(nb_blocks):
        for s in range(stripes_per_block):
            accumulate_512(b * block_len + s * 64, s * 8)
        for i in range(8):
            a = acc[i]
            a ^= a >> 47
            a ^= _r64(sec, len(sec) - 64 + 8 * i)
            acc[i] = (a * _P32_1) & _M64
    n_stripes = ((n - 1) - block_len * nb_blocks) // 64
    for s in range(n_stripes):
        accumulate_512(nb_blocks * block_len + s * 64, s * 8)
    accumulate_512(n - 64, len(sec) - 64 - 7)

    h = (n * _P64_1) & _M64
    for i in range(4):
        h = (h + _fold64(acc[2 * i] ^ _r64(sec, 11 + 16 * i),
                         acc[2 * i + 1] ^ _r64(sec, 11 + 16 * i + 8))) & _M64
    return _avalanche(h)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of ``data`` (equal to ``xxhash.xxh3_64_intdigest``)."""
    seed &= _M64
    n = len(data)
    s = _SECRET
    if n == 0:
        return _xxh64_avalanche(seed ^ (_r64(s, 56) ^ _r64(s, 64)))
    if n <= 3:
        combined = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
        bitflip = ((_r32(s, 0) ^ _r32(s, 4)) + seed) & _M64
        return _xxh64_avalanche(combined ^ bitflip)
    if n <= 8:
        lo32 = seed & 0xFFFFFFFF
        seed ^= int.from_bytes(lo32.to_bytes(4, "little"), "big") << 32
        in1 = _r32(data, 0)
        in2 = _r32(data, n - 4)
        bitflip = ((_r64(s, 8) ^ _r64(s, 16)) - seed) & _M64
        return _rrmxmx(((in2 + (in1 << 32)) & _M64) ^ bitflip, n)
    if n <= 16:
        bf1 = ((_r64(s, 24) ^ _r64(s, 32)) + seed) & _M64
        bf2 = ((_r64(s, 40) ^ _r64(s, 48)) - seed) & _M64
        lo = _r64(data, 0) ^ bf1
        hi = _r64(data, n - 8) ^ bf2
        acc = (n + _swap64(lo) + hi + _fold64(lo, hi)) & _M64
        return _avalanche(acc)
    if n <= 128:
        acc = (n * _P64_1) & _M64
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, s, 96, seed)
                    acc += _mix16(data, n - 64, s, 112, seed)
                acc += _mix16(data, 32, s, 64, seed)
                acc += _mix16(data, n - 48, s, 80, seed)
            acc += _mix16(data, 16, s, 32, seed)
            acc += _mix16(data, n - 32, s, 48, seed)
        acc += _mix16(data, 0, s, 0, seed)
        acc += _mix16(data, n - 16, s, 16, seed)
        return _avalanche(acc & _M64)
    if n <= 240:
        acc = (n * _P64_1) & _M64
        for i in range(8):
            acc += _mix16(data, 16 * i, s, 16 * i, seed)
        acc = _avalanche(acc & _M64)
        for i in range(8, n // 16):
            acc += _mix16(data, 16 * i, s, 16 * (i - 8) + 3, seed)
        acc += _mix16(data, n - 16, s, 136 - 17, seed)
        return _avalanche(acc & _M64)
    return _hash_long(data, seed)


def _token_bytes(tokens: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *tokens)


def compute_local_block_hash(tokens: Sequence[int]) -> int:
    """Content-only hash of one block of tokens."""
    return xxh3_64(_token_bytes(tokens), BLOCK_HASH_SEED)


def compute_block_hash(tokens: Sequence[int], parent_hash: Optional[int] = None) -> int:
    """Sequence-aware hash: chains the parent block's sequence hash."""
    prefix = struct.pack("<Q", parent_hash) if parent_hash is not None else b""
    return xxh3_64(prefix + _token_bytes(tokens), BLOCK_HASH_SEED)


def compute_block_hashes_for_seq(
    tokens: Sequence[int], block_size: int, salt: Optional[bytes] = None
) -> List[int]:
    """Sequence hashes for every *full* block of ``tokens``."""
    hashes: List[int] = []
    parent: Optional[int] = None
    if salt:
        parent = xxh3_64(salt, BLOCK_HASH_SEED)
    for start in range(0, len(tokens) - block_size + 1, block_size):
        parent = compute_block_hash(tokens[start : start + block_size], parent)
        hashes.append(parent)
    return hashes


@dataclass(frozen=True)
class TokenBlock:
    """One immutable, full block of tokens with its chained identity."""

    tokens: Tuple[int, ...]
    block_hash: int  # sequence-aware (chained)
    local_hash: int  # content-only
    parent_hash: Optional[int]  # previous block's sequence hash (None for root)
    position: int  # block index within the sequence

    def __len__(self) -> int:
        return len(self.tokens)


class TokenBlockSequence:
    """Splits a growing token stream into hashed, chained blocks; full blocks
    are sealed once, the tail partial block stays a plain list."""

    def __init__(
        self,
        tokens: Optional[Iterable[int]] = None,
        block_size: int = 64,
        salt: Optional[bytes] = None,
    ):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.salt = salt
        self._salt_hash: Optional[int] = (
            xxh3_64(salt, BLOCK_HASH_SEED) if salt else None
        )
        self._blocks: List[TokenBlock] = []
        self._partial: List[int] = []
        if tokens is not None:
            self.extend(tokens)

    @property
    def blocks(self) -> Tuple[TokenBlock, ...]:
        return tuple(self._blocks)

    @property
    def partial_tokens(self) -> Tuple[int, ...]:
        return tuple(self._partial)

    @property
    def tokens(self) -> List[int]:
        out: List[int] = []
        for b in self._blocks:
            out.extend(b.tokens)
        out.extend(self._partial)
        return out

    def block_hashes(self) -> List[int]:
        return [b.block_hash for b in self._blocks]

    def __len__(self) -> int:
        return len(self._blocks) * self.block_size + len(self._partial)

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the newly sealed block if one completed."""
        self._partial.append(token)
        if len(self._partial) == self.block_size:
            return self._seal()
        return None

    def extend(self, tokens: Iterable[int]) -> List[TokenBlock]:
        """Append many tokens; returns all blocks sealed along the way."""
        sealed: List[TokenBlock] = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                sealed.append(b)
        return sealed

    def truncate(self, n_tokens: int) -> None:
        """Shrink the sequence to ``n_tokens`` (drops sealed blocks as needed)."""
        if n_tokens >= len(self):
            return
        all_tokens = self.tokens[:n_tokens]
        self._blocks.clear()
        self._partial.clear()
        self.extend(all_tokens)

    def _seal(self) -> TokenBlock:
        parent = self._blocks[-1].block_hash if self._blocks else self._salt_hash
        toks = tuple(self._partial)
        block = TokenBlock(
            tokens=toks,
            block_hash=compute_block_hash(toks, parent),
            local_hash=compute_local_block_hash(toks),
            parent_hash=parent,
            position=len(self._blocks),
        )
        self._blocks.append(block)
        self._partial.clear()
        return block
