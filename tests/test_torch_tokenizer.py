"""The port's pure-Python tokenizer against the ``tokenizers`` library: encode,
decode (ids outside the vocabulary included) and the streaming DecodeStream,
on the test fixture's trained byte-level BPE and on the byte-level file that
chip_smoke.py writes."""

import json
import random

import pytest
from tokenizers import Tokenizer

from chip_smoke import byte_level_tokenizer_json
from dynamo_tpu.llm.tokenizer import HFTokenizer as JaxHFTokenizer
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer, gpt2_split

from .fixtures import _CORPUS, build_tokenizer

TEXTS = _CORPUS + [
    "<|user|>hello there<|assistant|>", "a  b\n\nc  \t x", "it's 'll don't I'M",
    " ½ ² x１２ ", "emoji 😀 test", "  leading", "trailing  ", "", "<s></s>mid<|system|>",
]


def _pair(kind):
    tk = build_tokenizer() if kind == "fixture" else Tokenizer.from_str(
        json.dumps(byte_level_tokenizer_json()))
    return tk, HFTokenizer(json.loads(tk.to_str()))


def _random_texts(seed, n=150):
    rng = random.Random(seed)
    alphabet = "ab c\n\t'!é你😀12<|s>/"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randrange(30))) for _ in range(n)]


@pytest.mark.parametrize("kind", ["fixture", "chip_smoke"])
def test_encode_decode_match_tokenizers(kind):
    tk, pt = _pair(kind)
    for text in TEXTS + _random_texts(1):
        ids = tk.encode(text, add_special_tokens=False).ids
        assert pt.encode(text) == ids, text
        assert pt.decode(ids) == tk.decode(ids), text
    rng = random.Random(2)
    for _ in range(300):
        # ids past the vocabulary: the 128256-way model emits them
        ids = [rng.randrange(0, 1200) for _ in range(rng.randrange(12))]
        for skip in (True, False):
            assert pt.decode(ids, skip) == tk.decode(ids, skip_special_tokens=skip), ids


@pytest.mark.parametrize("kind", ["fixture", "chip_smoke"])
def test_decode_stream_matches(kind):
    tk, pt = _pair(kind)
    ref = JaxHFTokenizer(tk)
    rng = random.Random(3)
    for text in TEXTS[:9]:
        ids = tk.encode(text, add_special_tokens=False).ids
        ids = ids + [rng.randrange(0, 1200) for _ in range(4)]
        a, b = pt.decode_stream(), ref.decode_stream()
        assert [a.step(i) for i in ids] == [b.step(i) for i in ids], text


def test_gpt2_split_rules():
    # as tokenizers' ByteLevel pre-tokenizer splits them
    assert gpt2_split("it's a  b\n\nc") == ["it", "'s", " a", " ", " b", "\n", "\n", "c"]
    assert gpt2_split("x  ") == ["x", "  "]
    assert gpt2_split("12ab!?") == ["12", "ab", "!?"]
