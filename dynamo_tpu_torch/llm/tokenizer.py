"""Tokenizer: a pure-Python reader of HF ``tokenizer.json`` for byte-level BPE,
plus incremental streaming decode and the stop-sequence jail.

:class:`HFTokenizer` reads the model's vocabulary, merges and added tokens,
splits text on added tokens, pre-tokenizes with the GPT-2 pattern (written
as a scanner over Unicode categories, since ``re`` has no ``\\p{L}``), maps
bytes through the ByteLevel byte↔unicode table and applies the BPE merges by
rank. Decoding follows the ``tokenizers`` library: ids outside the
vocabulary are dropped, special added tokens are skipped on request, and
the ByteLevel decoder maps characters back to bytes (a token with a
character outside the table contributes its own UTF-8 bytes) and decodes
them lossily.

:class:`DecodeStream` and :class:`StopSequenceDecoder` are the JAX
package's (``llm/tokenizer.py``), unchanged.
"""

from __future__ import annotations

import enum
import json
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable-unicode-character table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_B2U = bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _cls(ch: str) -> str:
    cat = unicodedata.category(ch)[0]
    if cat == "L":
        return "L"
    if cat == "N":
        return "N"
    if ch.isspace():
        return "S"
    return "O"


def gpt2_split(text: str) -> List[str]:
    """The GPT-2 pre-tokenizer pattern
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                out.append(c)
                i += len(c)
                break
        else:
            j = i + 1 if text[i] == " " and i + 1 < n and _cls(text[i + 1]) != "S" else i
            kind = _cls(text[j])
            if kind != "S":
                k = j + 1
                while k < n and _cls(text[k]) == kind:
                    k += 1
                out.append(text[i:k])
                i = k
                continue
            k = i
            while k < n and _cls(text[k]) == "S":
                k += 1
            if k < n and k - i > 1:
                k -= 1  # \s+(?!\S): leave the last space to prefix the next word
            out.append(text[i:k])
            i = k
    return out


class HFTokenizer:
    """Byte-level BPE tokenizer read from an HF ``tokenizer.json``."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported tokenizer model {model.get('type')!r}")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "ByteLevel":
            raise ValueError(f"unsupported pre_tokenizer {pre.get('type')!r}")
        if spec.get("normalizer") is not None:
            raise ValueError("tokenizer normalizers are not supported")
        self._prefix_space = bool(pre.get("add_prefix_space", False))
        self._use_regex = bool(pre.get("use_regex", True))
        self._byte_decoder = (spec.get("decoder") or {}).get("type") == "ByteLevel"
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._vocab: Dict[str, int] = dict(model.get("vocab") or {})
        ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            ranks[(a, b)] = r
        self._ranks = ranks
        self._added: Dict[str, int] = {}
        self._special_ids = set()
        for t in spec.get("added_tokens") or []:
            self._added[t["content"]] = int(t["id"])
            self._vocab.setdefault(t["content"], int(t["id"]))
            if t.get("special"):
                self._special_ids.add(int(t["id"]))
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._added_by_len = sorted(self._added, key=len, reverse=True)
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- encode --------------------------------------------------------------

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is_added_token) in order; leftmost-longest added matches."""
        out: List[Tuple[str, bool]] = []
        i = start = 0
        while i < len(text):
            hit = next((t for t in self._added_by_len if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if start < i:
                out.append((text[start:i], False))
            out.append((hit, True))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _bpe(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self._ignore_merges and word in self._vocab:
            ids = [self._vocab[word]]
        else:
            parts = list(word)
            while len(parts) > 1:
                best = None
                for j in range(len(parts) - 1):
                    r = self._ranks.get((parts[j], parts[j + 1]))
                    if r is not None and (best is None or r < best[0]):
                        best = (r, j)
                if best is None:
                    break
                j = best[1]
                parts[j:j + 2] = [parts[j] + parts[j + 1]]
            ids = [self._vocab[p] for p in parts if p in self._vocab]
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids: List[int] = []
        first = True
        for piece, added in self._split_added(text):
            if added:
                ids.append(self._added[piece])
                continue
            if self._prefix_space and first and not piece.startswith(" "):
                piece = " " + piece
            first = False
            words = gpt2_split(piece) if self._use_regex else [piece]
            for w in words:
                mapped = "".join(_B2U[b] for b in w.encode("utf-8"))
                ids.extend(self._bpe(mapped))
        return ids

    # -- decode --------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and int(i) in self._special_ids):
                continue
            tokens.append(tok)
        if not self._byte_decoder:
            return "".join(tokens)
        buf = bytearray()
        for t in tokens:
            try:
                buf.extend(_U2B[c] for c in t)
            except KeyError:
                buf.extend(t.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens=skip_special_tokens)


class DecodeStream:
    """Incremental detokenizer.

    Decodes a growing id sequence and only emits text once it is stable: if the
    freshly decoded suffix ends in U+FFFD (a partial UTF-8 sequence from a split
    multi-byte token), emission waits for more tokens.
    """

    def __init__(self, tokenizer: HFTokenizer, skip_special_tokens: bool = True):
        self._tk = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: list[int] = []
        self._prefix_offset = 0
        self._read_offset = 0

    def step(self, token_id: int) -> Optional[str]:
        """Feed one token id; return newly stable text (or None)."""
        self._ids.append(token_id)
        prefix_text = self._tk.decode(
            self._ids[self._prefix_offset : self._read_offset], self._skip_special
        )
        full_text = self._tk.decode(self._ids[self._prefix_offset :], self._skip_special)
        if full_text.endswith("�"):
            # partial multi-byte sequence: hold until complete
            return None
        new_text = full_text[len(prefix_text) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return new_text if new_text else None


class JailState(str, enum.Enum):
    OPEN = "open"  # text flows freely
    JAILED = "jailed"  # partial stop-sequence match held back
    STOPPED = "stopped"  # full stop-sequence matched; stream complete


@dataclass
class StopDecision:
    text: Optional[str]  # text safe to emit now (None = nothing new)
    stopped: bool  # a stop sequence fully matched
    stop_token: bool = False  # stopped because of a stop *token id*


class StopSequenceDecoder:
    """Streaming decode with hidden stop sequences: text that could begin a
    stop string is withheld until disambiguated; a matched stop string ends
    the stream and is never emitted."""

    def __init__(
        self,
        tokenizer: HFTokenizer,
        stop_sequences: Sequence[str] = (),
        stop_token_ids: Sequence[int] = (),
        hidden: bool = True,
        skip_special_tokens: bool = True,
    ):
        self._decode = DecodeStream(tokenizer, skip_special_tokens)
        self._stops = [s for s in stop_sequences if s]
        self._stop_ids = set(stop_token_ids)
        self._hidden = hidden
        self._pending = ""  # jailed text
        self._state = JailState.OPEN

    @property
    def state(self) -> JailState:
        return self._state

    def step(self, token_id: int) -> StopDecision:
        if self._state is JailState.STOPPED:
            return StopDecision(text=None, stopped=True)

        if token_id in self._stop_ids:
            self._state = JailState.STOPPED
            text = self._pending or None
            self._pending = ""
            return StopDecision(text=text, stopped=True, stop_token=True)

        piece = self._decode.step(token_id)
        if piece is None:
            return StopDecision(text=None, stopped=False)

        buf = self._pending + piece

        if self._stops:
            earliest = -1
            for s in self._stops:
                idx = buf.find(s)
                if idx != -1 and (earliest == -1 or idx < earliest):
                    earliest = idx
            if earliest != -1:
                self._state = JailState.STOPPED
                self._pending = ""
                emit = buf[:earliest] if self._hidden else buf
                return StopDecision(text=emit or None, stopped=True)

            jail_len = _longest_stop_prefix_suffix(buf, self._stops)
            if jail_len > 0:
                emit = buf[:-jail_len]
                self._pending = buf[-jail_len:]
                self._state = JailState.JAILED
                return StopDecision(text=emit or None, stopped=False)

        self._pending = ""
        self._state = JailState.OPEN
        return StopDecision(text=buf or None, stopped=False)

    def flush(self) -> Optional[str]:
        """Release any jailed text at end of stream (no stop ever matched)."""
        text, self._pending = self._pending, ""
        return text or None


def _longest_stop_prefix_suffix(buf: str, stops: Sequence[str]) -> int:
    """Length of the longest buffer-suffix that is a proper prefix of any stop."""
    best = 0
    for s in stops:
        max_k = min(len(buf), len(s) - 1)
        for k in range(max_k, best, -1):
            if buf.endswith(s[:k]):
                best = k
                break
    return best
