"""Tokenizer: a pure-Python reader of HF ``tokenizer.json`` for BPE models,
plus incremental streaming decode and the stop-sequence jail.

:class:`HFTokenizer` follows the ``tokenizers`` library step by step, for
the pieces the served families' files use, and raises ``ValueError`` naming
any other piece (nothing falls back silently):

- added tokens split the text first (leftmost-longest), before the
  normalizer for tokens with ``normalized: false``, after it for the rest;
- normalizers ``NFC``, ``Prepend``, ``Replace`` (string patterns) and a
  ``Sequence`` of them, applied to each piece between added tokens;
- pre-tokenizers ``ByteLevel`` (with or without its GPT-2 regex, with
  ``add_prefix_space``), ``Split`` (``Isolated``, not inverted) on the
  llama-3 or qwen2 pattern, and a ``Sequence`` of them. ``re`` has
  no ``\\p{L}``, so each pattern is a scanner over Unicode categories that
  takes the alternatives in the regex's order, with its backtracking
  written out;
- the BPE model: merges by rank, ``ignore_merges``, ``byte_fallback``
  (a character outside the vocabulary becomes its UTF-8 bytes as ``<0xXX>``
  tokens), ``unk_token`` and ``fuse_unk``;
- decoders ``ByteLevel``, and a ``Sequence`` of ``Replace``,
  ``ByteFallback`` (runs of ``<0xXX>`` joined into bytes; invalid UTF-8
  gives U+FFFD per byte), ``Fuse``, ``Strip`` and ``ByteLevel``. Ids outside
  the vocabulary are dropped, special added tokens skipped on request.

The llama-3 and qwen2 files are BPE over ByteLevel bytes behind a regex
``Split``; the mixtral (SentencePiece-converted) file is BPE over
characters with byte fallback behind a ``Prepend``/``Replace`` normalizer.

:class:`DecodeStream` and :class:`StopSequenceDecoder` are the JAX
package's (``llm/tokenizer.py``), unchanged.
"""

from __future__ import annotations

import enum
import json
import unicodedata
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple


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
_CONTRACTION_TAILS = ("s", "t", "re", "ve", "m", "ll", "d")
# (?i:...) folds these letters too: U+017F LATIN SMALL LETTER LONG S is s
_FOLDS = {"s": "sSſ", "t": "tT", "r": "rR", "e": "eE", "v": "vV", "m": "mM", "l": "lL",
          "d": "dD"}

# the Split patterns the scanners implement, as tokenizer.json writes them
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


@lru_cache(maxsize=65536)
def _cls(ch: str) -> str:
    """The regex class of a character: "L" (``\\p{L}``), "N" (``\\p{N}``), "S" (``\\s``:
    Unicode White_Space, which ``str.isspace`` widens by U+001C-U+001F) or
    "O" (anything else)."""
    cat = unicodedata.category(ch)[0]
    if cat == "L":
        return "L"
    if cat == "N":
        return "N"
    if ch.isspace() and not "\x1c" <= ch <= "\x1f":
        return "S"
    return "O"


def _run(text: str, i: int, kind: str) -> int:
    """The end of the run of ``kind`` characters from ``i``."""
    n = len(text)
    while i < n and _cls(text[i]) == kind:
        i += 1
    return i


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
                k = _run(text, j + 1, kind)
                out.append(text[i:k])
                i = k
                continue
            k = _run(text, i, "S")
            if k < n and k - i > 1:
                k -= 1  # \s+(?!\S): leave the last space to prefix the next word
            out.append(text[i:k])
            i = k
    return out


def _contraction_end(text: str, i: int) -> int:
    """``(?i:'s|'t|'re|'ve|'m|'ll|'d)`` at ``i``: the match's end, or -1."""
    if text[i] != "'":
        return -1
    for tail in _CONTRACTION_TAILS:
        j = i + 1
        for c in tail:
            if j >= len(text) or text[j] not in _FOLDS[c]:
                break
            j += 1
        else:
            return j
    return -1


def _llama3_match(text: str, i: int, max_digits: int) -> int:
    """The end of the llama-3 pattern's match at ``i`` (qwen2's with
    ``max_digits`` 1). Every character starts a match."""
    n = len(text)
    j = _contraction_end(text, i)
    if j >= 0:
        return j
    ch = text[i]
    kind = _cls(ch)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if kind == "L":
        return _run(text, i, "L")
    if kind != "N" and ch not in "\r\n" and i + 1 < n and _cls(text[i + 1]) == "L":
        return _run(text, i + 1, "L")
    # \p{N}{1,3}
    if kind == "N":
        j = i + 1
        while j < n and j - i < max_digits and _cls(text[j]) == "N":
            j += 1
        return j
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    j = i + 1 if ch == " " else i
    if j < n and _cls(text[j]) == "O":
        j = _run(text, j, "O")
        while j < n and text[j] in "\r\n":
            j += 1
        return j
    # ch is \s here. \s*[\r\n]+: the run up to its last line break
    end, last_break = i, -1
    while end < n and _cls(text[end]) == "S":
        if text[end] in "\r\n":
            last_break = end
        end += 1
    if last_break >= 0:
        return last_break + 1
    # \s+(?!\S): the run to the end of the text, or all but its last space
    if end == n or end - i == 1:
        return end  # (\s+ for a lone space before a non-space)
    return end - 1


def llama3_split(text: str, max_digits: int = 3) -> List[str]:
    """The llama-3 Split pattern (:data:`LLAMA3_PATTERN`); with
    ``max_digits`` 1 the qwen2 one (:data:`QWEN2_PATTERN`)."""
    out: List[str] = []
    i = 0
    while i < len(text):
        j = _llama3_match(text, i, max_digits)
        out.append(text[i:j])
        i = j
    return out


_SPLITTERS: Dict[str, Callable[[str], List[str]]] = {
    LLAMA3_PATTERN: llama3_split,
    QWEN2_PATTERN: lambda text: llama3_split(text, max_digits=1),
}


def _string_pattern(spec: dict, what: str) -> str:
    pattern = spec.get("pattern") or {}
    if set(pattern) != {"String"}:
        raise ValueError(f"unsupported {what} pattern {pattern!r}: only string patterns")
    return pattern["String"]


def _normalizer(spec: Optional[dict]) -> Optional[Callable[[str], str]]:
    """A normalizer of the file, as a function of one piece of text."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec.get("normalizers") or []]

        def chain(text: str) -> str:
            for step in steps:
                text = step(text)
            return text
        return chain
    if kind == "NFC":
        return lambda text: unicodedata.normalize("NFC", text)
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda text: prefix + text if text else text
    if kind == "Replace":
        old, new = _string_pattern(spec, "Replace normalizer"), spec["content"]
        return lambda text: text.replace(old, new)
    raise ValueError(f"unsupported normalizer {kind!r}")


def _byte_level(add_prefix_space: bool, use_regex: bool) -> Callable[[str], List[str]]:
    def step(piece: str) -> List[str]:
        if add_prefix_space and not piece.startswith(" "):
            piece = " " + piece
        words = gpt2_split(piece) if use_regex else [piece]
        return ["".join(_B2U[b] for b in w.encode("utf-8")) for w in words]
    return step


def _pre_tokenizer(spec: Optional[dict]) -> List[Callable[[str], List[str]]]:
    """The pre-tokenizer of the file as steps, each splitting one piece into
    pieces (empty pieces are dropped between steps, as ``tokenizers`` does)."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for s in spec.get("pretokenizers") or [] for step in _pre_tokenizer(s)]
    if kind == "ByteLevel":
        return [_byte_level(bool(spec.get("add_prefix_space", False)),
                            bool(spec.get("use_regex", True)))]
    if kind == "Split":
        pattern = spec.get("pattern") or {}
        regex = pattern.get("Regex")
        if set(pattern) != {"Regex"} or regex not in _SPLITTERS:
            raise ValueError(f"unsupported Split pattern {pattern!r}: the scanners cover the "
                             f"llama-3 and qwen2 regexes")
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise ValueError(f"unsupported Split behavior {spec.get('behavior')!r} (invert "
                             f"{spec.get('invert')!r}): only Isolated, not inverted")
        return [_SPLITTERS[regex]]
    raise ValueError(f"unsupported pre_tokenizer {kind!r}")


def _byte_token(token: str) -> Optional[int]:
    """The byte of a ``<0xXX>`` token, as ``tokenizers``' ByteFallback reads
    it (six bytes, two hex digits after ``<0x``, or ``+`` and one), else None."""
    if len(token.encode("utf-8")) != 6 or not token.startswith("<0x") or not token.endswith(">"):
        return None
    digits = token[3:5]
    body = digits[1:] if digits.startswith("+") else digits
    if not body or any(c not in "0123456789abcdefABCDEF" for c in body):
        return None
    return int(body, 16)


def _decode_byte_level(tokens: List[str]) -> List[str]:
    buf = bytearray()
    for t in tokens:
        try:
            buf.extend(_U2B[c] for c in t)
        except KeyError:
            buf.extend(t.encode("utf-8"))
    return [buf.decode("utf-8", errors="replace")]


def _decode_byte_fallback(tokens: List[str]) -> List[str]:
    out: List[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in run)
            run.clear()
    for t in tokens:
        b = _byte_token(t)
        if b is None:
            flush()
            out.append(t)
        else:
            run.append(b)
    flush()
    return out


def _strip(content: str, start: int, stop: int) -> Callable[[List[str]], List[str]]:
    def step(tokens: List[str]) -> List[str]:
        out = []
        for t in tokens:
            a, b = 0, len(t)
            while a < min(start, len(t)) and t[a] == content:
                a += 1
            while len(t) - b < stop and b > a and t[b - 1] == content:
                b -= 1
            out.append(t[a:b])
        return out
    return step


def _decoder(spec: Optional[dict]) -> Optional[Callable[[List[str]], List[str]]]:
    """A decoder of the file as ``tokenizers``' decode_chain: token strings
    in, strings out (joined by the caller)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec.get("decoders") or []]

        def chain(tokens: List[str]) -> List[str]:
            for step in steps:
                tokens = step(tokens)
            return tokens
        return chain
    if kind == "ByteLevel":
        return _decode_byte_level
    if kind == "ByteFallback":
        return _decode_byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Replace":
        old, new = _string_pattern(spec, "Replace decoder"), spec["content"]
        return lambda tokens: [t.replace(old, new) for t in tokens]
    if kind == "Strip":
        return _strip(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
    raise ValueError(f"unsupported decoder {kind!r}")


class HFTokenizer:
    """A BPE tokenizer read from an HF ``tokenizer.json`` (see the module
    note for what it takes)."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported tokenizer model {model.get('type')!r}")
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout"):
            if model.get(key) is not None:
                raise ValueError(f"unsupported BPE option {key}={model[key]!r}")
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode_chain = _decoder(spec.get("decoder"))
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._byte_fallback = bool(model.get("byte_fallback", False))
        self._fuse_unk = bool(model.get("fuse_unk", False))
        self._vocab: Dict[str, int] = dict(model.get("vocab") or {})
        unk = model.get("unk_token")
        self._unk = self._vocab[unk] if unk is not None and unk in self._vocab else None
        ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            ranks[(a, b)] = r
        self._ranks = ranks
        # added tokens matched on the raw text (normalized: false) and on
        # the normalized pieces (normalized: true), longest first
        self._added: Dict[str, int] = {}
        self._special_ids = set()
        raw, normalized = [], []
        for t in spec.get("added_tokens") or []:
            self._added[t["content"]] = int(t["id"])
            self._vocab.setdefault(t["content"], int(t["id"]))
            if t.get("special"):
                self._special_ids.add(int(t["id"]))
            (normalized if t.get("normalized") and self._normalize else raw).append(t["content"])
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._raw_added = sorted(raw, key=len, reverse=True)
        self._norm_added = sorted(normalized, key=len, reverse=True)
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    # -- encode --------------------------------------------------------------

    @staticmethod
    def _split_added(text: str, added: List[str]) -> List[Tuple[str, bool]]:
        """(piece, is_added_token) in order; leftmost-longest added matches."""
        out: List[Tuple[str, bool]] = []
        i = start = 0
        while i < len(text) and added:
            hit = next((t for t in added if text.startswith(t, i)), None)
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

    def _symbols(self, word: str) -> List[str]:
        """The word's characters as BPE symbols before the merges: a
        character outside the vocabulary becomes its ``<0xXX>`` byte tokens
        (byte fallback), else the unknown token (runs of them fused with
        ``fuse_unk``), else nothing."""
        out: List[str] = []
        unk_pending = False
        for ch in word:
            if ch in self._vocab:
                if unk_pending:
                    out.append(self._id_to_token[self._unk])
                    unk_pending = False
                out.append(ch)
                continue
            if self._byte_fallback:
                fallback = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
                if all(t in self._vocab for t in fallback):
                    out.extend(fallback)
                    continue
            if self._unk is not None:
                if unk_pending and not self._fuse_unk:
                    out.append(self._id_to_token[self._unk])
                unk_pending = True
        if unk_pending:
            out.append(self._id_to_token[self._unk])
        return out

    def _bpe(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self._ignore_merges and word in self._vocab:
            ids = [self._vocab[word]]
        else:
            parts = self._symbols(word)
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
            ids = [self._vocab[p] for p in parts]
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids

    def _pieces(self, text: str) -> List[Tuple[str, bool]]:
        """The text split on added tokens and normalized between them."""
        out: List[Tuple[str, bool]] = []
        for piece, added in self._split_added(text, self._raw_added):
            if added or self._normalize is None:
                out.append((piece, added))
                continue
            out.extend(self._split_added(self._normalize(piece), self._norm_added))
        return out

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids: List[int] = []
        for piece, added in self._pieces(text):
            if added:
                ids.append(self._added[piece])
                continue
            words = [piece] if piece else []
            for step in self._pre:
                words = [w for p in words for w in step(p) if w]
            for w in words:
                ids.extend(self._bpe(w))
        return ids

    # -- decode --------------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and int(i) in self._special_ids):
                continue
            tokens.append(tok)
        if self._decode_chain is None:
            return " ".join(tokens)
        return "".join(self._decode_chain(tokens))

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
