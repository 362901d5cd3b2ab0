"""The port's pure-Python tokenizer against the ``tokenizers`` library and the
JAX package's ``HFTokenizer``: encode, decode (ids outside the vocabulary
included) and the streaming DecodeStream, id for id and string for string,
on the test fixture's trained byte-level BPE, the byte-level file that
chip_smoke.py writes, specs of the llama-3, qwen2 and mixtral files' shapes
trained in-process, and the mixtral-shaped file chip_smoke.py writes; a
model directory holding such a spec served over HTTP on the CPU; and the
pieces the reader does not take, refused by name."""

import asyncio
import http.client
import json
import os
import random

import pytest
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

from chip_smoke import byte_level_tokenizer_json, mixtral_tokenizer_json
from dynamo_tpu.llm.tokenizer import HFTokenizer as JaxHFTokenizer
from dynamo_tpu_torch.llm.tokenizer import (
    LLAMA3_PATTERN,
    QWEN2_PATTERN,
    HFTokenizer,
    gpt2_split,
    llama3_split,
)

from .fixtures import _CORPUS, build_model_dir, build_tokenizer

TEXTS = _CORPUS + [
    "<|user|>hello there<|assistant|>", "a  b\n\nc  \t x", "it's 'll don't I'M",
    " ½ ² x１２ ", "emoji 😀 test", "  leading", "trailing  ", "", "<s></s>mid<|system|>",
]


# the texts of the llama-3-, qwen2- and mixtral-shaped specs: CJK, emoji,
# digit runs, line breaks of every kind, contractions in either case (and
# the long s that (?i) folds), unusual spaces, byte-fallback characters and
# added tokens inside words
SPEC_CORPUS = _CORPUS + [
    "Don't stop: it's 2024, we'll see 1234567 items!", "I'M HERE, YOU'RE THERE; THEY'VE GONE",
    "line one\r\nline two\n\n  indented\ttab \r\r", "数字１２３ and ٣٤٥ Ⅻ ½ 😀😀 ǅungla",
]
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<s>", "</s>", "<|user|>"]
_PIECES = ["a", "b", "Zq", " ", "  ", "\n", "\r\n", "\r", "\t", "'", "'s", "'S", "'LL", "'ve",
           "'Re", "'ſ", "1", "23", "4567", "é", "e\u0301", "你", "好", "😀", "!", "?!", ".", "\xa0",
           "\u3000", "\x1c", "\x85", "<s>", "</s>", "<|eot_id|>", "<|user|>", "½", "٣", "Ⅻ", "ǅ",
           "\u200b", "_", "▁", "ＡＢ", "x", "the", " quick"]


def _trained(kind):
    """A BPE trained in-process in the shape of the family's tokenizer.json:
    llama-3 (Split on its regex, then ByteLevel without regex,
    ignore_merges), qwen2 (the same with its regex and an NFC normalizer),
    or mixtral (Prepend/Replace normalizer, byte fallback over <0xXX> tokens
    at ids 3-258 as SentencePiece lays them out, the Sequence decoder)."""
    if kind == "mixtral":
        tk = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
        tk.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                              normalizers.Replace(" ", "▁")])
        tk.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                        decoders.Fuse(), decoders.Strip(" ", 1, 0)])
        tk.train_from_iterator(SPEC_CORPUS, trainers.BpeTrainer(
            vocab_size=400, special_tokens=["<unk>", "<s>", "</s>"], show_progress=False))
        spec = json.loads(tk.to_str())
        vocab = spec["model"]["vocab"]
        order = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + [
            t for t in sorted(vocab, key=vocab.get) if t not in ("<unk>", "<s>", "</s>")]
        spec["model"]["vocab"] = {t: i for i, t in enumerate(order)}
        for added in spec["added_tokens"]:
            added["id"] = spec["model"]["vocab"][added["content"]]
        return Tokenizer.from_str(json.dumps(spec))
    pattern = {"llama3": LLAMA3_PATTERN, "qwen2": QWEN2_PATTERN}[kind]
    tk = Tokenizer(models.BPE(unk_token=None, ignore_merges=kind == "llama3"))
    if kind == "qwen2":
        tk.normalizer = normalizers.NFC()
    tk.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tk.decoder = decoders.ByteLevel()
    tk.train_from_iterator(SPEC_CORPUS, trainers.BpeTrainer(
        vocab_size=700, special_tokens=SPECIALS, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tk


def _pair(kind):
    if kind == "fixture":
        tk = build_tokenizer()
    elif kind == "chip_smoke":
        tk = Tokenizer.from_str(json.dumps(byte_level_tokenizer_json()))
    elif kind == "chip_smoke_mixtral":
        tk = Tokenizer.from_str(json.dumps(mixtral_tokenizer_json()))
    else:
        tk = _trained(kind)
    return tk, HFTokenizer(json.loads(tk.to_str()))


def _random_texts(seed, n=150):
    rng = random.Random(seed)
    alphabet = "ab c\n\t'!é你😀12<|s>/"
    return ["".join(rng.choice(alphabet) for _ in range(rng.randrange(30))) for _ in range(n)]


def _random_spec_texts(seed, n=200):
    rng = random.Random(seed)
    return ["".join(rng.choice(_PIECES) for _ in range(rng.randrange(25))) for _ in range(n)]


KINDS = ["fixture", "chip_smoke", "llama3", "qwen2", "mixtral", "chip_smoke_mixtral"]


@pytest.mark.parametrize("kind", KINDS)
def test_encode_decode_match_tokenizers(kind):
    tk, pt = _pair(kind)
    texts = TEXTS + _random_texts(1)
    if kind not in ("fixture", "chip_smoke"):
        texts += SPEC_CORPUS + _random_spec_texts(4)
    for text in texts:
        ids = tk.encode(text, add_special_tokens=False).ids
        assert pt.encode(text) == ids, text
        assert pt.decode(ids) == tk.decode(ids), text
    rng = random.Random(2)
    top = tk.get_vocab_size() + 200
    for _ in range(300):
        # ids past the vocabulary: the 128256-way model emits them; in the
        # mixtral shapes runs of <0xXX> ids that are not valid UTF-8
        ids = [rng.randrange(0, top) for _ in range(rng.randrange(12))]
        if kind.endswith("mixtral"):
            ids += [rng.randrange(3, 259) for _ in range(rng.randrange(4))]
        for skip in (True, False):
            assert pt.decode(ids, skip) == tk.decode(ids, skip_special_tokens=skip), ids


@pytest.mark.parametrize("kind", KINDS)
def test_decode_stream_matches(kind):
    tk, pt = _pair(kind)
    ref = JaxHFTokenizer(tk)
    rng = random.Random(3)
    texts = TEXTS[:9] if kind in ("fixture", "chip_smoke") else SPEC_CORPUS
    for text in texts:
        ids = tk.encode(text, add_special_tokens=False).ids
        ids = ids + [rng.randrange(0, tk.get_vocab_size() + 200) for _ in range(4)]
        a, b = pt.decode_stream(), ref.decode_stream()
        assert [a.step(i) for i in ids] == [b.step(i) for i in ids], text


def test_byte_fallback_stream_withholds_a_partial_character():
    tk, pt = _pair("mixtral")
    ids = tk.encode("a € b", add_special_tokens=False).ids
    tokens = [tk.id_to_token(i) for i in ids]
    cut = tokens.index("<0xE2>")  # € by byte fallback: E2 82 AC
    assert tokens[cut:cut + 3] == ["<0xE2>", "<0x82>", "<0xAC>"]
    stream = pt.decode_stream()
    out = [stream.step(i) for i in ids]
    assert out[cut] is None and out[cut + 1] is None  # a part of €: nothing yet
    assert "".join(filter(None, out)) == tk.decode(ids) == "a € b"


def test_gpt2_split_rules():
    # as tokenizers' ByteLevel pre-tokenizer splits them
    assert gpt2_split("it's a  b\n\nc") == ["it", "'s", " a", " ", " b", "\n", "\n", "c"]
    assert gpt2_split("x  ") == ["x", "  "]
    assert gpt2_split("12ab!?") == ["12", "ab", "!?"]
    # U+001C-U+001F are not \s (Unicode White_Space) though str.isspace says so
    assert gpt2_split("a \x1cb") == ["a", " \x1c", "b"]
    assert gpt2_split("a\x1c\x1d b") == ["a", "\x1c\x1d", " b"]
    assert gpt2_split("x \x1f  y") == ["x", " \x1f", " ", " y"]


def test_split_scanners_follow_the_regexes():
    regex = pytest.importorskip("regex")
    for pattern, split in ((LLAMA3_PATTERN, llama3_split),
                           (QWEN2_PATTERN, lambda t: llama3_split(t, max_digits=1))):
        compiled = regex.compile(pattern)
        for text in SPEC_CORPUS + _random_spec_texts(6, 300):
            assert split(text) == compiled.findall(text), text


@pytest.mark.parametrize("where,piece,name", [
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+|\s+"}, "behavior": "Isolated",
                       "invert": False}, r"\\w\+"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
                       "behavior": "Removed", "invert": False}, "Removed"),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁"}, "Metaspace"),
    ("normalizer", {"type": "Lowercase"}, "Lowercase"),
    ("normalizer", {"type": "Sequence", "normalizers": [{"type": "NFKC"}]}, "NFKC"),
    ("normalizer", {"type": "Replace", "pattern": {"Regex": " +"}, "content": "▁"}, "Regex"),
    ("decoder", {"type": "WordPiece", "prefix": "##"}, "WordPiece"),
    ("decoder", {"type": "Sequence", "decoders": [{"type": "CTC"}]}, "CTC"),
])
def test_unsupported_pieces_raise_with_their_names(where, piece, name):
    spec = byte_level_tokenizer_json()
    spec[where] = piece
    with pytest.raises(ValueError, match=name):
        HFTokenizer(spec)


@pytest.mark.parametrize("kind", ["llama3", "mixtral"])
def test_model_dir_with_the_spec_serves_over_http_on_cpu(kind, tmp_path):
    """``ModelDeploymentCard.from_local_path`` on a directory holding the
    family's tokenizer.json; ``in=http out=torch --device cpu`` answers a
    streaming completion with the prompt tokenized as ``tokenizers`` does
    and the same text and chunks as the JAX package's frontend (its own
    tokenizer over the same file) puts on the wire for the same engine."""
    from dynamo_tpu.cli.run import _token_pipelines as jax_token_pipelines
    from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
    from dynamo_tpu.llm.http.service import ModelManager as JaxModelManager
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
    from dynamo_tpu_torch.cli.run import build_engine, build_parser, make_service
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols.openai import CompletionRequest

    from .test_torch_http import _JaxWire, _Served, _shape, _sse

    tk, _ = _pair(kind)
    path = build_model_dir(str(tmp_path / kind))
    tk.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    config.update(vocab_size=tk.get_vocab_size(), bos_token_id=tk.token_to_id("<s>"),
                  eos_token_id=tk.token_to_id("</s>"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    flags = build_parser().parse_args(
        ["--model-path", path, "--device", "cpu", "--host", "127.0.0.1", "--port", "0"])
    chat, comp, name, core = build_engine("torch", flags)
    served = _Served(make_service(chat, comp, name, flags))
    jchat, jcomp = jax_token_pipelines(JaxCard.from_local_path(path), lambda: _JaxWire(core))
    manager = JaxModelManager()
    manager.add_chat_model(name, jchat)
    manager.add_completions_model(name, jcomp)
    jax_served = _Served(JaxHttpService(manager, host="127.0.0.1", port=0))
    try:
        body = {"model": name, "stream": True, "max_tokens": 6, "prompt": "Don't stop 12345 你好",
                "nvext": {"ignore_eos": True}, "stream_options": {"include_usage": True}}
        lowered = OpenAIPreprocessor(ModelDeploymentCard.from_local_path(path)
                                     ).preprocess_completion(CompletionRequest.from_dict(body))
        assert lowered.token_ids == tk.encode(body["prompt"], add_special_tokens=False).ids
        chunks = _sse(served.port, "/v1/completions", body)
        jax_chunks = _sse(jax_served.port, "/v1/completions", body)

        def text(cs):
            return "".join(c["choices"][0].get("text") or "" for c in cs)

        assert text(chunks) == text(jax_chunks)
        assert [_shape(c) for c in chunks] == [_shape(c) for c in jax_chunks]
        assert chunks[-1]["usage"]["completion_tokens"] == 6
    finally:
        served.close()
        jax_served.close()
        core.close()
