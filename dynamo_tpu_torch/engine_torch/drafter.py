"""Self-drafting for speculative decoding: prompt-lookup / n-gram proposals.

The port's copy of the JAX package's ``engine_jax/drafter.py``. Decode is
bound by the weight stream: a dispatch that verifies k drafted tokens plus
samples one fresh token streams the weights ONCE for up to k+1 emitted
tokens. The drafter proposes those k tokens with no second model: it
indexes the sequence's own token stream (prompt + generated so far) by
trailing n-gram and, when the current suffix has occurred before, proposes
the tokens that followed that earlier occurrence. Repetition-heavy traffic
(multi-turn chat quoting context, code edits, extraction copying spans)
accepts most of the proposal; random text accepts almost none, and the
engine falls back to the plain pipelined decode step whenever no lane can
draft.

Correctness never depends on the drafts: the engine's verify dispatch
(``sampling.speculative_targets``) samples the engine's OWN target token at
every position and keeps exactly the drafted prefix that MATCHES those
targets, plus the first non-matching target as the bonus token, so greedy
speculative output equals non-speculative greedy output.

Env knobs (malformed values degrade to safe defaults):

- ``DYN_TPU_SPEC_K``      draft tokens verified per decode dispatch
                          (0 = speculation off, the default; clamped to
                          [0, MAX_SPEC_K]).
- ``DYN_TPU_SPEC_NGRAM``  longest trailing n-gram probed for a match
                          (clamped to [1, 8]; shorter grams are probed as
                          fallback down to MIN_NGRAM).

The KV page dtype knob (``DYN_TPU_KV_DTYPE``) is read by ``engine.py``'s
``env_kv_dtype``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..runtime.envknobs import env_raw

# hard bound on draft length: each draft position adds a verified lm_head
# column and a KV write; past ~16 the acceptance tail can't pay for the
# extra FLOPs even at high match rates
MAX_SPEC_K = 16
MIN_NGRAM = 2

# adaptive dormancy: a sequence whose drafts keep getting rejected stops
# proposing (the engine then runs plain pipelined decode for it) — this is
# what bounds the adversarial-workload overhead near zero
DORMANT_MIN_DRAFTED = 48
DORMANT_ACCEPT_FLOOR = 0.08


def env_spec_k(default: int = 0) -> int:
    """``DYN_TPU_SPEC_K`` with clamping: unset/malformed → default, negative
    → 0 (off), oversized → MAX_SPEC_K."""
    raw = env_raw("DYN_TPU_SPEC_K")
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return max(0, min(v, MAX_SPEC_K))


def env_spec_ngram(default: int = 3) -> int:
    """``DYN_TPU_SPEC_NGRAM`` clamped to [1, 8]."""
    raw = env_raw("DYN_TPU_SPEC_NGRAM")
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return max(1, min(v, 8))


class NgramDrafter:
    """Per-sequence suffix index over prompt + generated tokens.

    ``_index[n]`` maps each n-gram (as a tuple) to the position *after* its
    most recent occurrence; :meth:`extend` keeps the maps current as tokens
    are emitted (O(ngram_max) per token, a handful of dict writes).
    :meth:`draft` probes the longest gram first — longer matches predict
    longer accepted runs — and proposes the tokens that followed the match.

    The drafter owns its copy of the token stream (``_toks``); preemption
    re-admissions don't disturb it because the logical stream (prompt +
    generated, concatenated) is append-only for the life of the request.
    """

    __slots__ = ("k", "ngram_max", "_toks", "_index", "drafted", "accepted")

    def __init__(self, prompt: Sequence[int], k: int, ngram_max: int = 3):
        self.k = k
        self.ngram_max = max(MIN_NGRAM, min(ngram_max, 8))
        self._toks: List[int] = []
        # one map per gram length: tuple(gram) -> (position after the most
        # recent occurrence, position after the one before it). Two entries
        # because the stream's live suffix registers ITSELF on every append —
        # a draft for that suffix needs the occurrence before it.
        self._index: Dict[
            int, Dict[Tuple[int, ...], Tuple[int, Optional[int]]]
        ] = {n: {} for n in range(MIN_NGRAM, self.ngram_max + 1)}
        self.drafted = 0  # draft tokens handed to verify dispatches
        self.accepted = 0  # of those, how many matched the sampled target
        self.extend(prompt)

    def __len__(self) -> int:
        return len(self._toks)

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def dormant(self) -> bool:
        return (
            self.drafted >= DORMANT_MIN_DRAFTED
            and self.accept_rate < DORMANT_ACCEPT_FLOOR
        )

    def extend(self, tokens: Sequence[int]) -> None:
        """Append emitted tokens, registering every n-gram they complete.
        Later occurrences overwrite earlier ones (the most recent match is
        the best predictor of what follows the current suffix)."""
        toks = self._toks
        for t in tokens:
            toks.append(int(t))
            end = len(toks)
            for n in range(MIN_NGRAM, self.ngram_max + 1):
                if end >= n:
                    d = self._index[n]
                    key = tuple(toks[end - n:end])
                    prior = d.get(key)
                    d[key] = (end, prior[0] if prior is not None else None)

    def note_result(self, drafted: int, accepted: int) -> None:
        self.drafted += drafted
        self.accepted += accepted

    def would_draft(self) -> bool:
        """Cheap pre-dispatch gate: does the index hold a prior (non-self)
        occurrence of any trailing gram? Same lookups as :meth:`draft`
        without building the proposal. The engine consults this BEFORE
        draining the pipelined decode chunk — a verify dispatch is only
        worth the drain if some lane can plausibly propose, so workloads
        whose streams never repeat (the adversarial case) keep the plain
        pipelined decode path at the cost of a few dict probes per step.
        The answer is stale by the in-flight decode chunk (up to
        ``decode_steps`` tokens not yet appended), so a repetition that
        first completes inside that chunk engages speculation up to one
        chunk late — a conservative miss, never a wrong answer; once the
        chunk drains and the match is indexed, every later probe sees it."""
        if self.dormant:
            return False
        toks = self._toks
        end = len(toks)
        for n in range(self.ngram_max, MIN_NGRAM - 1, -1):
            if end < n:
                continue
            hit = self._index[n].get(tuple(toks[end - n:end]))
            if hit is None:
                continue
            pos = hit[0] if hit[0] < end else hit[1]
            if pos is not None and pos < end:
                return True
        return False

    def draft(self) -> Optional[List[int]]:
        """Propose up to ``k`` continuation tokens for the current suffix,
        longest matching gram first. None = no proposal (no gram match, the
        match points at the stream's live end, or the drafter went dormant
        after sustained rejection)."""
        if self.dormant:
            return None
        toks = self._toks
        end = len(toks)
        for n in range(self.ngram_max, MIN_NGRAM - 1, -1):
            if end < n:
                continue
            hit = self._index[n].get(tuple(toks[end - n:end]))
            if hit is None:
                continue
            # the live suffix always matches itself (registered on append):
            # skip to the occurrence before it
            pos = hit[0] if hit[0] < end else hit[1]
            if pos is None or pos >= end:
                continue
            out = toks[pos:pos + self.k]
            if out:
                return list(out)
        return None
