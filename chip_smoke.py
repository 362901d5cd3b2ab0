#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port runs its main path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and nothing of JAX. Phases, in order (16, 21 and 17 run
right after 13, before mixtral takes the card; 19 and 20 after 18, each on
a card that every earlier engine has left); any failure exits non-zero:

1. device: prints the card's name and power limit (nvidia-smi);
2. build: compiles every kernel of the path from ``dynamo_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. kernels: holds the paged decode kernels against their plain PyTorch
   version on the card, in every regime the JAX kernels covered and with one
   lane, and times kernel, plain version and the library call beside it over
   runs of many calls cycling through inputs larger than L2; at two shapes
   it also times the kernel at split counts around the planner's; then the
   int8-KV rows: ``paged_decode_attention_int8`` in the same regimes and at
   8 lanes x 8192 tokens (llama3-8b's native context) against its plain
   version, against the fp64 evaluation of the same int8 pages and scales
   (its root-mean-square error held to that of the bf16 kernel on
   ``dequantize_kv(pages)``, both largest errors printed), timed eager and
   graph-replayed beside its bound, its plain version, the bf16 kernel on
   bf16 pages of the same lengths, and "dequantize the gathered pages, then
   the bf16 kernel" (a two-call yardstick: no single PyTorch call computes
   this function), and swept across split counts around its plan in three
   regimes; then the tp rows: ``paged_decode_attention_sharded`` (the
   kernel per rank, ranks co-located on the card) at the per-rank shapes of
   llama3-8b at tp=2 and llama3-70b at tp=4 and tp=8, 8 lanes x 2048: each
   rank against the plain version, all heads against the unsharded kernel
   at the same forced split count, the planned splits, eager and
   graph-replayed ms per rank call and for all ranks of one layer beside
   the bound, the plain version and SDPA;
4. int8 kernel: holds ``int8_weight_matmul`` against its plain version at
   the llama3-8b projection shapes (M = 1 and 8, and M = 64, 256 and 1024
   = an ``"int8-all"`` prefill chunk for 4096->14336), prints each shape's
   plan (kernel, block, splits) and checks that the call launched it, times
   it eager and graph-replayed beside the plain version and bf16
   ``torch.matmul`` on the same activations (eager and graph-replayed), and
   times both kernels forced on either side of the planner's threshold; M =
   40 is a speculative verify dispatch (8 lanes x 5 positions), summed over
   its 225 products like a decode step at M = 8; then llama3-70b's five
   shapes (K 8192 -> N 8192, 1024, 28672 and 128256, K 28672 -> N 8192) and
   one tp=2 rank's six at llama3-8b widths, each at M = 8 and 1024, the
   same way, summed per decode step (561 and 225 products) and per prefill
   chunk;
5. expert kernel: holds ``int8_expert_matmul`` against its plain version
   over 8 experts at mixtral-8x7b's 4096->14336 and 14336->4096, C = 2, 4
   (decode at 8 lanes), 5, 17, 130 and 512 (a 1024-row prefill chunk), with
   the plan it printed and launched, and the expert tile kernel forced where
   the plan takes split-K; prints each one's drift from the plain product
   summed in fp64 beside the fp32 plain product's; times the planned kernel
   eager and graph-replayed, the expert tile, the dense tile and the split-K
   kernels forced, the bound, the plain version and bf16 ``torch.bmm`` over
   a bf16 expert stack; times split-K and the expert tile kernel forced
   across the planner's cut; sums a decode step and a prefill chunk; then
   one tp=2 rank's stacks at F/2 (4096->7168 and 7168->4096) at C = 4 and
   512, summed alike;
6. load: writes a llama3-8b-width checkpoint cut to 2 layers (bf16, HF
   names, two ``*.safetensors`` files), serves it through
   ``cli.run.build_engine``, checks every parameter on the card bit for bit
   against what was written, and answers 2 streaming requests over HTTP;
7. serve: starts ``dynamo_tpu_torch.cli.run``'s HTTP server in this process
   on a llama3-8b-width model with random weights, answers 8 concurrent
   streaming requests, and checks the launch counts of both paged kernels
   (as the wrapper counts them where it launches them); then profiles a few
   steady decode dispatches of a second wave of requests and counts the
   kernels' device events per wrapper call;
8. decode parity: one full-width ``forward_window`` step through the paged
   kernel and through its plain version;
9. int8 serve: the same model and requests behind an
   ``EngineConfig(quantize="int8")`` engine (the bf16 engine closed first);
   checks 225 int8 launches per decode step (7 per layer, 32 layers, and the
   LM head) and the paged kernels' launches, and profiles it alike;
10. int8 parity: one full-width ``forward_window`` step of the int8 tree,
    and one ``forward_chunk`` as the ``"int8-all"`` mode runs it (225
    products of 1024 rows, all on the tile kernel), through the int8
    kernels and through their plain version; prints, not held, the same
    chunk's drift between the plain version summed in fp64 and in fp32;
11. int8 KV serve: the bf16 weights of phases 7 and 9 behind an engine
    with ``kv_dtype="int8"`` and the host-RAM KV tier (the int8 engine
    closed first), its pool sized so that a second wave of 8 other prompts
    evicts the first wave's cached blocks to host RAM and a third wave of
    the first prompts finds them there: checks 32
    ``paged_decode_attention_int8`` launches per decode step and none of the
    bf16 paged kernel, host hits, and every injected page and scale
    bit-equal to what was spilled; profiles decode; then one full-width
    ``forward_window`` step over an int8 pool through the kernel against its
    plain version, and prints (not held) its drift from the same step with
    the pool dequantized for the bf16 kernel and from a bf16 pool;
    the integrity plane is on in every phase, as by default;
12. integrity (every llama engine closed, the bf16 weights kept; each run a
    fresh engine at llama3-8b width and full depth, 8 lanes of 100-500
    random prompt tokens driven through ``generate``): a ``poison`` fault on
    the third decode dispatch ends every lane with the watchdog's resume
    directive after exactly the tokens of the dispatches before it, equal
    to a clean run's; TTFT p50, decode tok/s and the seal checksums' seconds
    with ``DYN_TPU_KV_INTEGRITY=0`` against the default (printed); a
    ``corrupt`` fault on the first host-tier spill of phase 11's three-wave
    layout (int8 pages, a pool that holds one wave): one entry fails its
    checksum, the third wave takes fewer host hits, one ``kv`` trip is
    counted, and its tokens equal a clean run's third wave;
13. spec serve: ``spec_k = 4`` on 8 streams of 64 tokens over prompts that
    repeat a phrase, bf16 and then ``quantize="int8"``, each beside a
    spec-off engine: drafted and accepted tokens (held), accept rate, tokens
    per verify dispatch, TTFT and tok/s on and off, stream agreement
    (printed); each spec-on wave's launches against its dispatches (held:
    225 W8A16 products per int8 verify dispatch and decode step, 32 paged
    calls per decode step; M = 40 plans printed); one verify and one decode
    dispatch profiled on the idle engine (device ms); the 225 products of a
    verify dispatch at M = 40 (phase 4's times) printed; then the verify
    forward's logits against the same positions decoded one step at a
    time, held at 2e-2 for bf16 and int8 weights (the int8 products of up
    to 64 rows run on the split-K kernel on both paths), beside the int8
    case's parts: plain products on both sides (printed), and the int8
    verify forward through the W8A16 kernels against the same forward
    through their plain version (held at 2e-2); and each path, bf16 and
    int8, against an fp32 evaluation of the same weights (held at 2e-2);
14. mixtral load (every llama engine closed first): writes a
    mixtral-8x7b-width checkpoint cut to 1 layer (bf16, HF
    ``block_sparse_moe`` names), loads it straight to int8, checks every q
    and s on the card bit for bit against the quantization of what was
    written, and serves 2 streaming requests from it in ``"int8-all"``;
15. mixtral serve: mixtral-8x7b at full width and depth, random weights
    drawn straight to int8 on the card, behind the HTTP server in
    ``"int8-all"``, its prompts read by a mixtral-shaped tokenizer.json
    (``mixtral_tokenizer_json``: SentencePiece-style BPE with byte
    fallback; phase 14 reads it too): peak memory, 8 concurrent streams of
    32 tokens, launch counts (129 ``int8_weight_matmul``, 96
    ``int8_expert_matmul`` per forward, 32 paged per decode step; each
    prefill chunk's expert products on the expert tile kernel), TTFT,
    decode tok/s and a profile;
16. tp serve (after phase 13, phase 7's weights kept): llama3-8b at full
    width and depth over a tp=2 mesh of two ranks on the one card, built
    through ``build_torch_serving_engine(..., tensor_parallel_size=2,
    devices=[...])`` from phase 7's seed (its weights checked to be phase
    7's, sharded), the integrity plane on, behind the HTTP service: 8
    streams of 32 tokens, launches held (one sharded call per layer and
    decode step, a split and a merge kernel per rank), texts against phase
    7's, TTFT, tok/s, collectives per step, profile, peak memory; one
    prefill chunk's and one decode step's logits held against the
    unsharded forward at 2e-2; ``"int8"`` at tp=2 (per-rank plans printed,
    int8 launches per decode step held, one decode step against the
    unsharded int8 tree at 2e-2); ``"int8-all"`` at tp=2, drawn onto the
    ranks from phase 7's seed (checked equal to phase 7's weights
    quantized, sharded), behind the HTTP service: 8 streams of 32 tokens,
    450 W8A16 launches per decode step and prefill chunk held, one prefill
    chunk and one decode step held against the unsharded ``"int8-all"``
    forward at 2e-2; a host-tier wave in phase 12's layout
    (injected rank pages bit-equal to their spills, crcs verified at the
    re-hit); with two cards, the ranks on two cards through NCCL against the
    co-located run (else printed as not run);
17. tp 70b: llama3-70b widths cut to 4 layers, bf16 random weights, tp=8
    on the one card (~11 GB), behind the HTTP service: 8 streams of 32
    tokens, launches held, profile (the per-rank kernel's share), one
    decode step held against the unsharded forward at 2e-2;
18. mixtral parity: one MoE layer at 8 and 1024 tokens, and one full-depth
    ``forward_window`` step through the kernels against the same step
    through every kernel's plain version, and through the int8 products'
    plain versions alone; routing choices that differ are counted, with the
    router-logit gaps where each lane first differs, and the logits are
    held on the lanes whose choices agree at every layer (at least half of
    them); then the kernels' step is run again routed to the plain run's
    expert choices, and the logits are held on every lane; last, one
    full-depth prefill chunk is timed with the expert products on the
    expert tile kernel and on the dense tile kernel, in turns;
19. llama3-70b at full width and depth (80 layers) in ``"int8-all"`` on the
    one card, random weights drawn layer by layer straight to int8, the KV
    pool sized from the memory the weights leave free: allocated bytes
    before the build, after it and at the serving peak beside the card's
    total; 8 streams of 32 tokens over HTTP (561 ``int8_weight_matmul`` and
    80 paged launches per decode step held, 561 per prefill chunk); TTFT,
    tok/s and a profile; one decode step and one 1024-row prefill chunk
    through the kernels against their plain versions, held block by block
    at 2e-2 (each attention and MLP block's output on the plain run's
    stream, and the logits); the free-running ratios printed, the decode's
    at 8, 16, 32 and 80 layers and the chunk's at 80, each beside its noise
    floor (the plain step against the same step with fp64-summed products);
20. mixtral tp: mixtral-8x7b at full width and depth in ``"int8-all"`` at
    tp=2 co-located (every expert at F/2 on each rank), behind the HTTP
    service: 8 streams of 32 tokens, launches held (per rank and forward
    129 ``int8_weight_matmul`` and 96 ``int8_expert_matmul``; one sharded
    paged call per layer and decode step), TTFT, tok/s and a profile; then
    a prefill chunk and a decode step over a pool the ranks prefilled, the
    tp run's residual stream (every block's output), routing choices and
    logits carried to the host; the tp tree freed, the unsharded tree drawn
    from the same seed (each rank's leaves checked against fingerprints of
    their slices) and run on the same inputs and pool: free-running, its
    ratio and the routing choices that differ printed, not held; forced
    onto the tp run's stream block by block (:func:`mixtral_tp_parity`),
    every block's output and the logits held at 2e-2;
21. observability (after 16, phase 7's bf16 weights kept): the dispatch
    gate (``csrc/dispatch_gate.cu``, the profiling plane's device timer)
    held against its plain version and timed; then fresh engines on the
    weights (llama3-8b, 32 layers, 8 slots, context 2048) behind
    ``cli.run``'s HTTP server: 8 streams of 32 tokens, each with its own
    ``traceparent``, with the default planes and ``DYN_TPU_PROFILE=1``;
    ``/live``, ``/metrics`` (8 successes, 4 per endpoint, TTFT count 8,
    inflight 0, the engine's phase histograms), ``/debug/traces`` (8
    traces under the sent ids, ``http.edge`` -> ``engine.request`` ->
    queue-wait, prefill and decode of 32 tokens), ``/debug/slo`` (the TTFT
    and ITL objectives with their events) and ``/debug/profile?trace=1``
    (Chrome-trace JSON; ``dispatches_total`` equal to the engine's chunk
    and decode dispatches) held; with every dispatch timed
    (``DYN_TPU_PROFILE_SAMPLE=1``), the engine's decode device time per
    step and device idle fraction held against ``torch.profiler``'s over
    the same decode dispatches, at least 4 (0.7-2x, within 0.10; the gaps
    between kernels printed as a share of the gated segments); TTFT p50
    and tok/s with the default planes against ``DYN_TPU_TRACE=0
    DYN_TPU_SLO=0`` and with ``DYN_TPU_PROFILE=1`` against profiling off
    (printed, not held); an engine with int8 weights, int8 KV, the host
    tier and ``spec_k`` 4, every dispatch timed over three waves: no gate
    timeout, timed chunk and verify dispatches, drafts and host-tier hits
    held;
22. prints the kernels' JSON line and, last, the device JSON line.
Each phase prints its seconds.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import gc
import http.client
import json
import os
import re
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager, nullcontext

ROOT = os.path.dirname(os.path.abspath(__file__))

# llama3-8b widths (models/llama.py LLAMA_PRESETS["llama3-8b"])
LLAMA3_8B = dict(vocab=128256, hidden=4096, ffn=14336, layers=32, heads=32, kv_heads=8,
                 head_dim=128, model_type="llama", rope_theta=500000.0)
# llama3-70b widths (LLAMA_PRESETS["llama3-70b"])
LLAMA3_70B = dict(LLAMA3_8B, hidden=8192, ffn=28672, layers=80, heads=64, kv_heads=8)
# mixtral-8x7b widths (LLAMA_PRESETS["mixtral-8x7b"])
MIXTRAL = dict(vocab=32000, hidden=4096, ffn=14336, layers=32, heads=32, kv_heads=8,
               head_dim=128, model_type="mixtral", rope_theta=1000000.0, experts=8, top_k=2)
CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<s>' + message['role'] + '\\n' + message['content'] + '</s>' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<s>assistant\\n' }}{% endif %}"
)
N_REQUESTS = 8
MAX_TOKENS = 32
PROFILE_TOKENS = 64  # the profiled second wave
PROFILE_DISPATCHES = 3
BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
FP32_PEAK = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet


def byte_level_tokenizer_json() -> dict:
    """A byte-level BPE tokenizer.json: the 256 byte tokens (ids 0-255, in
    GPT-2's byte↔unicode mapping) plus <s> (256) and </s> (257), no merges."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    b2u = {b: chr(c) for b, c in zip(bs, cs)}
    vocab = {b2u[b]: b for b in range(256)}
    vocab["<s>"] = 256
    vocab["</s>"] = 257
    added = [
        {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True}
        for i, t in ((256, "<s>"), (257, "</s>"))
    ]
    level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None, "pre_tokenizer": level, "post_processor": None,
        "decoder": dict(level), "model": {
            "type": "BPE", "dropout": None, "unk_token": None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
            "vocab": vocab, "merges": [],
        },
    }


def mixtral_tokenizer_json(vocab_size: int = MIXTRAL["vocab"]) -> dict:
    """A tokenizer.json of mixtral's shape (a SentencePiece BPE as
    ``transformers`` converts it): <unk>, <s> and </s> (ids 0-2), the 256 byte
    tokens ``<0x00>``-``<0xFF>`` (3-258), characters, then merged pieces up
    to ``vocab_size`` by a fixed rule (each piece in turn, joined with each
    lower-case letter); a ``Prepend("▁")``/``Replace(" ", "▁")`` normalizer,
    no pre-tokenizer, BPE with ``byte_fallback`` and ``fuse_unk``, and the
    ``Replace``/``ByteFallback``/``Fuse``/``Strip`` decoder."""
    specials = ["<unk>", "<s>", "</s>"]
    lower = list("etaoinshrdlucmfwypvbgkjqxz")
    chars = (["▁"] + lower + [c.upper() for c in lower] + list("0123456789")
             + list(".,!?'\"-:;()[]{}<>/\\@#$%^&*_+=|~`") + list("你好世界こんにちは"))
    tokens = specials + [f"<0x{b:02X}>" for b in range(256)] + chars
    seen, merges = set(tokens), []
    i = len(specials) + 256  # the piece joined next: characters, then merged pieces
    while len(tokens) < vocab_size:
        a = tokens[i]
        i += 1
        for b in lower:
            if a + b not in seen and len(tokens) < vocab_size:
                seen.add(a + b)
                tokens.append(a + b)
                merges.append([a, b])
    added = [
        {"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True}
        for i, t in enumerate(specials)
    ]
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None, "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {
            "type": "BPE", "dropout": None, "unk_token": "<unk>",
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
            "vocab": {t: i for i, t in enumerate(tokens)}, "merges": merges,
        },
    }


def write_model_dir(path: str, num_layers: int = LLAMA3_8B["layers"], arch=LLAMA3_8B,
                    text_vocab: bool = False) -> str:
    """config.json at ``arch``'s widths (llama3-8b or mixtral-8x7b, context
    2048), a tokenizer (the byte-level one; mixtral's shape for mixtral, or
    with ``text_vocab``, where every id of the model's vocabulary past the
    byte tokens decodes to text) and a chat template; no weight files
    (random weights)."""
    c = dict(arch, layers=num_layers)
    moe = "experts" in c
    sp = moe or text_vocab  # the SentencePiece-shaped tokenizer
    bos, eos = (1, 2) if sp else (256, 257)
    config = {
        "architectures": ["MixtralForCausalLM" if moe else "LlamaForCausalLM"],
        "model_type": c["model_type"],
        "vocab_size": c["vocab"], "hidden_size": c["hidden"],
        "intermediate_size": c["ffn"], "num_hidden_layers": c["layers"],
        "num_attention_heads": c["heads"], "num_key_value_heads": c["kv_heads"],
        "head_dim": c["head_dim"], "max_position_embeddings": 2048,
        "rms_norm_eps": 1e-5, "rope_theta": c["rope_theta"], "bos_token_id": bos,
        "eos_token_id": eos, "tie_word_embeddings": False,
    }
    if moe:
        config.update(num_local_experts=c["experts"], num_experts_per_tok=c["top_k"])
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        spec = mixtral_tokenizer_json(c["vocab"]) if sp else byte_level_tokenizer_json()
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "chat_template": CHAT_TEMPLATE,
                   "model_max_length": 2048}, f)
    return path


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def hbm_rate(card_name: str) -> float:
    """Data-sheet HBM rate of the named H100 part, bytes/s."""
    return 2.0e12 if "PCIe" in card_name else 3.35e12


# -- phase 1/2 ------------------------------------------------------------------

def phase_device() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi: {res.stderr.strip()}")
    line = res.stdout.strip().splitlines()[0]
    print(line)
    return line


def _kernel_label(ln: str) -> str:
    """A readable name for ptxas's mangled entry name (template arguments
    included)."""
    m = re.search(r"(paged_decode_\w+?_kernel)I(13__nv_bfloat16|f)E?(?:Li(\d+)E)?", ln)
    if m:
        return (f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'fp32'}"
                + (f", D={m.group(3)}>" if m.group(3) else ">"))
    m = re.search(r"(w8a16_splitk_kernel)ILi(\d+)ELi(\d+)E(13__nv_bfloat16|f)E", ln)
    if m:
        return (f"{m.group(1)}<rows={16 * int(m.group(2))}, MT={m.group(3)}, "
                f"out={'fp32' if m.group(4) == 'f' else 'bf16'}>")
    m = re.search(r"(w8a16_tile_kernel)ILi(\d+)E(13__nv_bfloat16|f)E", ln)
    if m:
        return f"{m.group(1)}<BN={m.group(2)}, out={'fp32' if m.group(3) == 'f' else 'bf16'}>"
    m = re.search(r"(w8a16_expert_tile_kernel)ILi(\d+)E(13__nv_bfloat16|f)E", ln)
    if m:
        return f"{m.group(1)}<BT={m.group(2)}, out={'fp32' if m.group(3) == 'f' else 'bf16'}>"
    m = re.search(r"(w8f32_kernel)I(13__nv_bfloat16|f)E", ln)
    if m:
        return f"{m.group(1)}<out={'fp32' if m.group(2) == 'f' else 'bf16'}>"
    return ln.split("'")[1] if "'" in ln else ln.strip()


def phase_build() -> None:
    from dynamo_tpu_torch.ops import dispatch_gate, int8_matmul, paged_attention
    from dynamo_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    infos = build_all([paged_attention.LIBRARY, int8_matmul.LIBRARY, dispatch_gate.LIBRARY])
    print(f"build: {len(infos)} sources, one nvcc each in parallel, in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, info in infos.items():
        print(f"build: {src}.cu in {info['seconds']:.2f} s -> {info['path']}")
        # -Xptxas -v: "Compiling entry function '<mangled>'", then its
        # spills, then its registers
        name, spills = "?", ""
        for ln in info["log"].splitlines():
            if "warning" in ln:
                print(f"  ptxas: {ln.strip()}")
            elif "Compiling entry function" in ln:
                name = _kernel_label(ln)
            elif "spill" in ln:
                spills = ln.strip()
            elif "registers" in ln:
                print(f"  ptxas: {name}: {ln.split(':', 1)[-1].strip()}; {spills}")


# -- phase 3 --------------------------------------------------------------------

REGIMES = [
    # name, S, H, KVH, D, bs, max_len
    ("llama3-8b decode (D=128, KVH=8, 8 lanes)", 8, 32, 8, 128, 16, 2048),
    ("many lanes (D=128, 64 lanes)", 64, 32, 8, 128, 16, 1024),
    ("llama3.2-1b heads (D=64, KVH=8)", 8, 32, 8, 64, 16, 2048),
    ("tiny heads (D=16, KVH=2)", 8, 4, 2, 16, 16, 256),
    ("one lane (D=128, KVH=8, 1 lane, 2048)", 1, 32, 8, 128, 16, 2048),
]
# regimes (indices into REGIMES) whose split count is swept around the plan
SWEEP = (0, 4)
SWEEP_SPLITS = (1, 2, 4, 8, 16, 32)
TIMED_CALLS = 60  # launches between one event pair
COLD_BYTES = 120e6  # live K/V bytes cycled through: over 2x the 50 MB L2
MAX_SETS = 48


def make_case(torch, S, H, KVH, D, bs, max_len, dtype, seed, dev="cuda"):
    """Ragged lengths with one padding lane (when there are two lanes or
    more), permuted tables with garbage past each lane's live pages, and NaN
    in every dead slot of a lane's last page (a kernel that loads one feeds
    0 * NaN into its value sum)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mb = -(-max_len // bs)
    lengths = rng.integers(1, max_len + 1, size=S)
    lengths[0] = max_len
    if S > 1:
        lengths[S // 2] = 0
    n_blocks = S * mb + 7
    perm = rng.permutation(n_blocks)[: S * mb].reshape(S, mb)
    k = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    v = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    tables = perm.astype(np.int32)
    for s in range(S):
        n_pages = -(-int(lengths[s]) // bs)
        tables[s, n_pages:] = 1 << 30
        if lengths[s] % bs:
            k[perm[s, n_pages - 1], lengths[s] % bs:] = np.nan
            v[perm[s, n_pages - 1], lengths[s] % bs:] = np.nan
    q = rng.standard_normal((S, H, D), dtype=np.float32)
    return (
        torch.from_numpy(q).to(dev, dtype), torch.from_numpy(k).to(dev, dtype),
        torch.from_numpy(v).to(dev, dtype), torch.from_numpy(tables).to(dev),
        torch.from_numpy(lengths.astype(np.int32)).to(dev),
    )


def timing_sets(torch, case, n_sets: int, seed: int) -> list:
    """``n_sets`` independent inputs of the case's shapes, tables and
    lengths: the case itself plus fresh q, K and V made on the card, so that
    cycling through them reads K/V that is not in L2."""
    q, k, v, tables, lengths = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sets = [case]
    for _ in range(n_sets - 1):
        sets.append(tuple(
            torch.randn(x.shape, generator=gen, device="cuda", dtype=torch.float32).to(x.dtype)
            for x in (q, k, v)
        ) + (tables, lengths))
    return sets


def time_many(torch, fns, calls: int = TIMED_CALLS, reps: int = 3) -> float:
    """ms per call: ``calls`` calls cycling through ``fns`` between one event
    pair (the median of ``reps`` such runs), after one warm-up pass."""
    calls = -(-max(calls, len(fns)) // len(fns)) * len(fns)
    for f in fns:
        f()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(calls):
            fns[i % len(fns)]()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def time_graph(torch, fns, calls: int = TIMED_CALLS, reps: int = 3) -> float:
    """ms per call of the same run captured once in a CUDA graph and
    replayed: the device's time with the host's enqueue taken out."""
    calls = -(-max(calls, len(fns)) // len(fns)) * len(fns)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def sdpa_library(torch, q, k_cache, v_cache, tables, lengths):
    """The library yardstick: scaled_dot_product_attention (enable_gqa) over
    K/V pre-gathered into contiguous [S, KVH, T, D] with a length mask; the
    gather is done here, outside the timed call."""
    S, H, D = q.shape
    _, bs, KVH, _ = k_cache.shape
    mb = tables.shape[1]
    n_pages = (lengths.long() + bs - 1) // bs
    live = torch.arange(mb, device=q.device)[None, :] < n_pages[:, None]
    t = torch.where(live, tables.long(), 0)
    k = k_cache[t].reshape(S, mb * bs, KVH, D).transpose(1, 2).contiguous()
    v = v_cache[t].reshape(S, mb * bs, KVH, D).transpose(1, 2).contiguous()
    mask = torch.arange(mb * bs, device=q.device)[None, :] < lengths[:, None].long()
    # dead slots hold NaN in these inputs: a masked key must not poison PV
    k = torch.where(mask[:, None, :, None], k, torch.zeros_like(k))
    v = torch.where(mask[:, None, :, None], v, torch.zeros_like(v))
    mask[:, 0] = True  # a padding lane still needs one key (its output is discarded)
    q4 = q[:, :, None, :]
    attn_mask = mask[:, None, None, :]
    f = torch.nn.functional.scaled_dot_product_attention

    def call():
        return f(q4, k, v, attn_mask=attn_mask, enable_gqa=True)

    return call


def bound(S, H, KVH, D, bs, lengths, itemsize, rate):
    """(bound_ms, bound_by, bytes, flops) for this call's live data."""
    total = int(lengths.sum())
    n_pages = sum(-(-int(x) // bs) for x in lengths)
    nbytes = (
        2 * total * KVH * D * itemsize  # live K and V rows, read once
        + S * H * D * itemsize  # q
        + S * H * D * itemsize + 2 * S * H * 4  # o, m, l
        + S * 4 + n_pages * 4  # lengths, live table entries
    )
    flops = 4 * total * H * D  # QK and PV
    peak = BF16_PEAK if itemsize == 2 else FP32_PEAK
    t_bytes, t_ops = nbytes / rate, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_kernels(card: str) -> dict:
    import torch

    from dynamo_tpu_torch.ops.paged_attention import (
        device_launches,
        paged_decode_attention,
        paged_decode_attention_plain,
        reset_launch_counts,
        splits_launched,
    )

    rate = hbm_rate(card)
    result = {}
    for ri, (name, S, H, KVH, D, bs, max_len) in enumerate(REGIMES):
        for dtype in (torch.float32, torch.bfloat16):
            case = make_case(torch, S, H, KVH, D, bs, max_len, dtype, 100 + ri)
            q, k, v, tables, lengths = case
            reset_launch_counts()
            o, m, l = paged_decode_attention(q, k, v, tables, lengths, return_stats=True)
            torch.cuda.synchronize()
            # what this call launched, as the wrapper counted it at the launch
            (splits,) = splits_launched
            dev_launches = sum(device_launches.values())
            po, pm, pl = paged_decode_attention_plain(q, k, v, tables, lengths, return_stats=True)
            err_o = (o.float() - po.float()).abs().max().item()
            err_m = (m - pm).abs().max().item()
            err_l = (l - pl).abs().max().item()
            if not torch.isfinite(o.float()).all():
                fail(f"{name} {dtype}: non-finite kernel output")
            if dtype == torch.float32:
                # l sums up to 2048 terms of size ~1 in another order than
                # the plain version, so it is held to 1e-5 relative to itself
                ok = (err_o <= 1e-5 and err_m <= 1e-5
                      and torch.allclose(l, pl, rtol=1e-5, atol=1e-5))
                tol = "atol 1e-5 on o/m, rtol 1e-5 on l"
            else:
                ok = (err_o <= 2e-2 and torch.allclose(m, pm, rtol=1e-3, atol=0)
                      and torch.allclose(l, pl, rtol=1e-3, atol=0))
                tol = "o atol 2e-2, m/l rtol 1e-3"
            dt = "fp32" if dtype == torch.float32 else "bf16"
            print(f"kernel vs plain [{name}, {dt}, {splits} splits, {dev_launches} device "
                  f"launches]: max|do| {err_o:.3e} "
                  f"max|dm| {err_m:.3e} max|dl| {err_l:.3e} ({tol}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"paged_decode_attention disagrees with its plain version: {name} {dt}")
            if dtype != torch.bfloat16:
                continue
            lens_np = lengths.cpu().numpy()
            b_ms, b_by, nbytes, flops = bound(S, H, KVH, D, bs, lens_np, 2, rate)
            live_kv = 2 * int(lens_np.sum()) * KVH * D * 2
            n_sets = min(MAX_SETS, max(4, -(-int(COLD_BYTES) // live_kv)))
            sets = timing_sets(torch, case, n_sets, 1000 + ri)
            cold = n_sets * live_kv > 100e6
            kern = [lambda a=a: paged_decode_attention(*a) for a in sets]
            ms = time_many(torch, kern)
            graph_ms = time_graph(torch, kern)
            sweep = {}
            if ri in SWEEP:
                for n in sorted({*SWEEP_SPLITS, splits}):
                    sweep[n] = time_graph(torch, [lambda a=a, n=n: paged_decode_attention(
                        *a, num_splits=n) for a in sets])
                print(f"  splits [{name}, bf16, graph-replayed ms; the plan is {splits}]: "
                      + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))
            plain_ms = time_many(torch, [lambda a=a: paged_decode_attention_plain(*a)
                                         for a in sets[:4]], calls=50, reps=1)
            lib_ms = time_many(torch, [sdpa_library(torch, *a) for a in sets[:4]])
            del sets, kern
            torch.cuda.empty_cache()
            share = b_ms / ms
            print(f"  time [{name}, bf16, {splits} splits, {dev_launches} device "
                  f"launches per call]: kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s, "
                  f"{share:.1%} of the bytes bound), graph-replayed {graph_ms:.4f} ms "
                  f"({b_ms / graph_ms:.1%}), bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB "
                  f"at {rate / 1e12:.2f} TB/s), plain {plain_ms:.4f} ms, library (SDPA "
                  f"enable_gqa on pre-gathered K/V, gather not timed) {lib_ms:.4f} ms; "
                  f"{TIMED_CALLS}+ calls per event pair over {n_sets} input sets, "
                  f"{n_sets * live_kv / 1e6:.0f} MB of live K/V "
                  f"({'exceeds' if cold else 'does not exceed'} 100 MB: "
                  f"{'cold' if cold else 'warm'} L2)")
            result[name] = dict(max_abs_err=err_o, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, bound_share=share,
                                library_ms=lib_ms, splits=splits,
                                device_launches_per_call=dev_launches, split_sweep_graph_ms=sweep,
                                tb_s=nbytes / ms / 1e9, cold_l2=cold, S=S, H=H, KVH=KVH, D=D,
                                live_tokens=int(lens_np.sum()))
    return result


# the tp rows of phase 3: the per-rank shapes of the tp meshes the port
# serves, 8 lanes x 2048, D = 128, bf16: name, H, KVH, tp (the rank then
# attends H/tp query heads over KVH/tp kv heads)
TP_REGIMES = [
    ("llama3-8b tp=2 (16 query heads over 4 kv heads per rank)", 32, 8, 2),
    ("llama3-70b tp=4 (16 over 2 per rank)", 64, 8, 4),
    ("llama3-70b tp=8 (8 over 1 per rank: a GQA group of 8 in 16 mma rows)", 64, 8, 8),
]


def rank_sets(torch, case, tp: int, n_sets: int, seed: int) -> list:
    """``n_sets`` inputs of a case's shapes for a tp mesh: (q [S, H, D],
    the ranks' contiguous k and v pools [N, bs, KVH/tp, D], tables,
    lengths); the first cut from the case itself, the others fresh on the
    card (so that cycling through them reads K/V that is not in L2)."""
    q, k, v, tables, lengths = case
    w = k.shape[2] // tp
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def cut(x):
        return [x[:, :, r * w:(r + 1) * w].contiguous() for r in range(tp)]

    def fresh(x):
        return torch.randn(x.shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(x.dtype)

    sets = [(q, cut(k), cut(v), tables, lengths)]
    for _ in range(n_sets - 1):
        sets.append((fresh(q), cut(fresh(k)), cut(fresh(v)), tables, lengths))
    return sets


def phase_tp_kernels(card: str) -> dict:
    """Phase 3 on a tp mesh: ``paged_decode_attention_sharded`` (the CUDA
    kernel per rank, ranks co-located on the card) at each per-rank shape
    of TP_REGIMES: every rank against the plain version (phase 3's bf16
    tolerance), all heads against the unsharded kernel at the same forced
    split count (0 expected: heads are independent; held at the plain
    tolerance), the planned splits, eager and graph-replayed ms per rank
    call and for all ranks of one layer, the bytes bound, the plain version
    and SDPA at the per-rank shape and over all heads."""
    import torch

    from dynamo_tpu_torch.ops.paged_attention import (
        device_launches,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_decode_attention_sharded,
        paged_decode_attention_sharded_plain,
        reset_launch_counts,
        splits_launched,
    )
    from dynamo_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rate = hbm_rate(card)
    S, D, bs, max_len = 8, 128, 16, 2048
    result = {}
    for ri, (name, H, KVH, tp) in enumerate(TP_REGIMES):
        mesh = make_mesh(MeshConfig(tp=tp), ["cuda:0"] * tp)
        case = make_case(torch, S, H, KVH, D, bs, max_len, torch.bfloat16, 300 + ri)
        q, k, v, tables, lengths = case
        lens_np = lengths.cpu().numpy()
        live_rank = 2 * int(lens_np.sum()) * (KVH // tp) * D * 2
        n_sets = min(MAX_SETS, max(4, -(-int(COLD_BYTES) // live_rank)))
        sets = rank_sets(torch, case, tp, n_sets, 3000 + ri)
        _, kp, vp, _, _ = sets[0]
        reset_launch_counts()
        o, m, l = paged_decode_attention_sharded(q, kp, vp, tables, lengths, mesh=mesh,
                                                 return_stats=True)
        torch.cuda.synchronize()
        splits = dict(splits_launched)
        dev_launches = dict(device_launches)
        if list(splits.values()) != [tp] or any(n != tp for n in dev_launches.values()):
            fail(f"{name}: the sharded call launched {dev_launches}, splits {splits}; "
                 f"expected one split and one merge kernel per rank")
        (n_split,) = splits
        po, pm, pl = paged_decode_attention_sharded_plain(q, kp, vp, tables, lengths,
                                                          mesh=mesh, return_stats=True)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(o, po))
        ok = err <= 2e-2 and all(
            torch.allclose(a, b, rtol=1e-3, atol=0) for a, b in zip(m + l, pm + pl))
        whole = paged_decode_attention(q, k, v, tables, lengths, return_stats=True,
                                       num_splits=n_split)
        diffs = [(torch.cat(a, dim=1).float() - b.float()).abs().max().item()
                 for a, b in zip((o, m, l), whole)]
        same = diffs[0] <= 2e-2 and all(
            torch.allclose(torch.cat(a, dim=1), b, rtol=1e-3, atol=0)
            for a, b in zip((m, l), whole[1:]))
        print(f"sharded kernel [{name}, bf16, tp={tp} co-located, {n_split} planned splits per "
              f"rank, {sum(dev_launches.values())} device launches]: ranks vs plain max|do| "
              f"{err:.3e} (o atol 2e-2, m/l rtol 1e-3) {'ok' if ok else 'MISMATCH'}; all "
              f"heads vs the unsharded kernel at {n_split} splits max|do| {diffs[0]:.3e}, "
              f"max|dm| {diffs[1]:.3e}, max|dl| {diffs[2]:.3e} (expected 0; held at the plain "
              f"tolerance) {'ok' if same else 'MISMATCH'}")
        if not (ok and same):
            fail(f"paged_decode_attention_sharded disagrees: {name}")
        rank_b_ms, rank_by, rank_bytes, _ = bound(S, H // tp, KVH // tp, D, bs, lens_np, 2, rate)
        b_ms, b_by, nbytes, _ = bound(S, H, KVH, D, bs, lens_np, 2, rate)
        w = H // tp
        rank_in = [(a[0][:, :w].contiguous(), a[1][0], a[2][0], a[3], a[4]) for a in sets]
        rank = [lambda a=a: paged_decode_attention(*a) for a in rank_in]
        layer = [lambda a=a: paged_decode_attention_sharded(*a, mesh=mesh) for a in sets]
        rank_ms, rank_graph_ms = time_many(torch, rank), time_graph(torch, rank)
        layer_ms, layer_graph_ms = time_many(torch, layer), time_graph(torch, layer)
        rank_plain_ms = time_many(torch, [lambda a=a: paged_decode_attention_plain(*a)
                                          for a in rank_in[:4]], calls=20, reps=1)
        layer_plain_ms = time_many(torch, [
            lambda a=a: paged_decode_attention_sharded_plain(*a, mesh=mesh) for a in sets[:4]],
            calls=8, reps=1)
        rank_lib_ms = time_many(torch, [sdpa_library(torch, *a) for a in rank_in[:4]])
        layer_lib_ms = time_many(torch, [sdpa_library(
            torch, a[0], torch.cat(a[1], dim=2), torch.cat(a[2], dim=2), a[3], a[4])
            for a in sets[:2]])
        del sets, rank_in, rank, layer
        torch.cuda.empty_cache()
        print(f"  time [{name}]: per rank call {rank_ms:.4f} ms eager, {rank_graph_ms:.4f} "
              f"graph-replayed, bound {rank_b_ms:.4f} ms ({rank_by}: {rank_bytes / 1e6:.1f} MB "
              f"at {rate / 1e12:.2f} TB/s; {rank_b_ms / rank_graph_ms:.1%} graph-replayed), "
              f"plain {rank_plain_ms:.4f}, SDPA at the rank's shape {rank_lib_ms:.4f}; all "
              f"{tp} ranks of one layer (one sharded call) {layer_ms:.4f} ms eager, "
              f"{layer_graph_ms:.4f} graph-replayed, bound {b_ms:.4f} ms, plain "
              f"{layer_plain_ms:.4f}, SDPA over all heads {layer_lib_ms:.4f}; {n_sets} input "
              f"sets, {n_sets * live_rank * tp / 1e6:.0f} MB of live K/V")
        result[name] = dict(H=H, KVH=KVH, tp=tp, rank_heads=H // tp, rank_kv_heads=KVH // tp,
                            splits=n_split, device_launches_per_call=sum(dev_launches.values()),
                            max_abs_err=err, unsharded_max_diff=diffs, rank_ms=rank_ms,
                            rank_graph_ms=rank_graph_ms, rank_bound_ms=rank_b_ms,
                            rank_plain_ms=rank_plain_ms, rank_library_ms=rank_lib_ms,
                            ms=layer_ms, graph_ms=layer_graph_ms, bound_ms=b_ms, bound_by=b_by,
                            plain_ms=layer_plain_ms, library_ms=layer_lib_ms,
                            bound_share=b_ms / layer_ms, live_tokens=int(lens_np.sum()))
    return result


# the int8-KV rows of phase 3: every regime above, plus llama3-8b's heads at
# its native context, where the KV bytes dominate
KV_INT8_REGIMES = REGIMES + [
    ("llama3-8b long context (D=128, KVH=8, 8 lanes, 8192)", 8, 32, 8, 128, 16, 8192),
]
# int8-KV regimes whose split count is swept around the plan: the slice's
# shape, many lanes, and the long context
KV_INT8_SWEEP = (0, 1, 5)
KV_INT8_SWEEP_SPLITS = (2, 4, 6, 8, 12, 16, 24)


def int8_pool(torch, case):
    """The per-token int8 quantization of a case's K/V, with NaN scales in
    the dead slots of each lane's last page (where the case has NaN K/V):
    stale scales a kernel must never read."""
    from dynamo_tpu_torch.ops.attention import quantize_kv

    q, k, v, tables, lengths = case
    dead = torch.isnan(k.float()).any(-1).any(-1)  # [N, bs]
    kq, vq, ks, vs = quantize_kv(torch.nan_to_num(k.float()), torch.nan_to_num(v.float()))
    ks[dead] = float("nan")
    vs[dead] = float("nan")
    return q, kq, vq, ks, vs, tables, lengths


def int8_timing_sets(torch, case8, n_sets: int, seed: int) -> list:
    """``n_sets`` inputs of the int8 case's shapes, tables and lengths: the
    case and fresh int8 pages and scales made on the card."""
    q, kq, vq, ks, vs, tables, lengths = case8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sets = [case8]
    for _ in range(n_sets - 1):
        pages = [torch.randint(-127, 128, kq.shape, generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(ks.shape, generator=gen, device="cuda") * 0.05 for _ in range(2)]
        qn = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        sets.append((qn, *pages, *scales, tables, lengths))
    return sets


def dequant_then_bf16(torch, q, kq, vq, ks, vs, tables, lengths, **kw):
    """The nearest two-call yardstick (not a library call): ``dequantize_kv``
    of each lane's table pages into a compact bf16 pool, then the bf16 paged
    kernel over it (``kw``: its keywords, e.g. ``return_stats``)."""
    from dynamo_tpu_torch.ops.attention import dequantize_kv
    from dynamo_tpu_torch.ops.paged_attention import paged_decode_attention

    S = q.shape[0]
    _, bs, KVH, D = kq.shape
    mb = tables.shape[1]
    n_pages = (lengths.long() + bs - 1) // bs
    live = torch.arange(mb, device=q.device)[None, :] < n_pages[:, None]
    t = torch.where(live, tables.long(), 0)
    compact = torch.arange(S * mb, dtype=torch.int32, device=q.device).reshape(S, mb)
    k = dequantize_kv(kq[t], ks[t], q.dtype).reshape(S * mb, bs, KVH, D)
    v = dequantize_kv(vq[t], vs[t], q.dtype).reshape(S * mb, bs, KVH, D)
    return paged_decode_attention(q, k, v, compact, lengths, **kw)


def int8_kv_bound(S, H, KVH, D, bs, lengths, rate):
    """(bound_ms, bound_by, bytes, flops) of the int8 kernel's call: q, the
    live int8 K and V rows and their fp32 scales read once, o, m and l
    written once."""
    total = int(lengths.sum())
    n_pages = sum(-(-int(x) // bs) for x in lengths)
    nbytes = (
        2 * total * KVH * D  # live int8 K and V rows
        + 2 * total * 4  # their scales
        + S * H * D * 2  # q (bf16)
        + S * H * D * 2 + 2 * S * H * 4  # o, m, l
        + S * 4 + n_pages * 4  # lengths, live table entries
    )
    flops = 4 * total * H * D
    t_bytes, t_ops = nbytes / rate, flops / BF16_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def rms(x) -> float:
    return x.double().pow(2).mean().sqrt().item()


def phase_kv_int8_kernel(card: str) -> dict:
    """Phase 3's int8-KV rows: ``paged_decode_attention_int8`` against its
    plain version (bf16 compute); against the fp64 evaluation of the same
    int8 pages and scales, beside the bf16 kernel on ``dequantize_kv(pages)``
    (held: the root-mean-square error no larger; the largest error printed);
    timed eager and graph-replayed beside its bound, its plain version, the
    bf16 kernel on bf16 pages of the same lengths and the two-call
    yardstick; its split count swept around the plan in three regimes."""
    import torch

    from dynamo_tpu_torch.ops.attention import dequantize_kv
    from dynamo_tpu_torch.ops.paged_attention import (
        int8_blocks_per_sm,
        int8_device_launches,
        paged_decode_attention,
        paged_decode_attention_int8,
        paged_decode_attention_int8_plain,
        reset_launch_counts,
        splits_launched,
    )

    rate = hbm_rate(card)
    resident = int8_blocks_per_sm(128, torch.bfloat16, torch.cuda.current_device())
    print(f"int8 KV kernel: {resident} resident blocks per SM at D=128, bf16 (the split "
          f"plan's one wave: {resident} x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs)")
    result = {}
    for ri, (name, S, H, KVH, D, bs, max_len) in enumerate(KV_INT8_REGIMES):
        case = make_case(torch, S, H, KVH, D, bs, max_len, torch.bfloat16, 300 + ri)
        case8 = int8_pool(torch, case)
        q, kq, vq, ks, vs, tables, lengths = case8
        reset_launch_counts()
        o, m, l = paged_decode_attention_int8(*case8, return_stats=True)
        torch.cuda.synchronize()
        (splits,) = splits_launched
        dev_launches = sum(int8_device_launches.values())
        po, pm, pl = paged_decode_attention_int8_plain(*case8, return_stats=True)
        err_o = (o.float() - po.float()).abs().max().item()
        ok = (torch.isfinite(o.float()).all().item() and err_o <= 2e-2
              and torch.allclose(m, pm, rtol=1e-3, atol=0)
              and torch.allclose(l, pl, rtol=1e-3, atol=0))
        # the fp64 evaluation of the same int8 values and scales, against
        # the kernel and against the bf16 kernel on dequantize_kv(pages)
        exact = paged_decode_attention_int8_plain(q.double(), kq, vq, ks, vs, tables, lengths)
        kd, vd = dequantize_kv(kq, ks, torch.bfloat16), dequantize_kv(vq, vs, torch.bfloat16)
        bo = paged_decode_attention(q, kd, vd, tables, lengths)
        torch.cuda.synchronize()
        rms_k, rms_b = rms(o.double() - exact), rms(bo.double() - exact)
        max_k = (o.double() - exact).abs().max().item()
        max_b = (bo.double() - exact).abs().max().item()
        closer = rms_k <= rms_b
        print(f"int8 KV kernel vs plain [{name}, bf16 compute, {splits} splits, {dev_launches} "
              f"device launches]: max|do| {err_o:.3e} max|dm| {(m - pm).abs().max().item():.3e} "
              f"max|dl| {(l - pl).abs().max().item():.3e} (o atol 2e-2, m/l rtol 1e-3) "
              f"{'ok' if ok else 'MISMATCH'}; vs the fp64 evaluation: rms|do| {rms_k:.3e} "
              f"against {rms_b:.3e} for the bf16 kernel on dequantize_kv(pages) "
              f"({'no farther' if closer else 'FARTHER'}; held), max|do| {max_k:.3e} against "
              f"{max_b:.3e} (printed)")
        if not ok:
            fail(f"paged_decode_attention_int8 disagrees with its plain version: {name}")
        if not closer:
            fail(f"paged_decode_attention_int8 is farther from the fp64 evaluation than the "
                 f"bf16 kernel on the dequantized pages: {name}")
        del po, pm, pl, bo, exact
        lens_np = lengths.cpu().numpy()
        b_ms, b_by, nbytes, _ = int8_kv_bound(S, H, KVH, D, bs, lens_np, rate)
        live_kv = 2 * int(lens_np.sum()) * KVH * D  # int8 bytes
        n_sets = min(MAX_SETS, max(4, -(-int(COLD_BYTES) // live_kv)))
        sets = int8_timing_sets(torch, case8, n_sets, 2000 + ri)
        kern = [lambda a=a: paged_decode_attention_int8(*a) for a in sets]
        ms = time_many(torch, kern)
        graph_ms = time_graph(torch, kern)
        sweep = {}
        if ri in KV_INT8_SWEEP:
            for n in sorted({*KV_INT8_SWEEP_SPLITS, splits}):
                sweep[n] = time_graph(torch, [lambda a=a, n=n: paged_decode_attention_int8(
                    *a, num_splits=n) for a in sets])
            print(f"  splits [{name}, int8 KV, graph-replayed ms; the plan is {splits}]: "
                  + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))
        plain_ms = time_many(torch, [lambda a=a: paged_decode_attention_int8_plain(*a)
                                     for a in sets[:4]], calls=20, reps=1)
        two_call_ms = time_many(torch, [lambda a=a: dequant_then_bf16(torch, *a)
                                        for a in sets[:4]], calls=20, reps=1)
        del sets, kern
        torch.cuda.empty_cache()
        # the bf16 kernel on bf16 pages of the same lengths, as cold
        bsets = timing_sets(torch, case, min(MAX_SETS, max(4, -(-int(COLD_BYTES) // (2 * live_kv)))),
                            3000 + ri)
        bkern = [lambda a=a: paged_decode_attention(*a) for a in bsets]
        bf16_ms = time_many(torch, bkern)
        bf16_graph_ms = time_graph(torch, bkern)
        del bsets, bkern, kd, vd
        torch.cuda.empty_cache()
        share = b_ms / ms
        print(f"  time [{name}, int8 KV, {splits} splits]: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e9:.3f} TB/s, {share:.1%} of the bytes bound), graph-replayed "
              f"{graph_ms:.4f} ms ({b_ms / graph_ms:.1%}), bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s), plain {plain_ms:.4f} ms, "
              f"dequantize-then-bf16-kernel (two calls, not a library call) {two_call_ms:.4f} "
              f"ms; the bf16 kernel on bf16 pages of the same lengths {bf16_ms:.4f} ms "
              f"(graph {bf16_graph_ms:.4f}); {n_sets} input sets, "
              f"{n_sets * live_kv / 1e6:.0f} MB of live int8 K/V")
        result[name] = dict(max_abs_err=err_o, fp64_rms_err=rms_k,
                            fp64_rms_err_bf16_kernel_dequantized=rms_b, fp64_max_err=max_k,
                            fp64_max_err_bf16_kernel_dequantized=max_b, ms=ms,
                            graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            bound_share=share, library_ms=None, dequant_then_bf16_ms=two_call_ms,
                            bf16_kernel_ms=bf16_ms, bf16_kernel_graph_ms=bf16_graph_ms,
                            splits=splits, split_sweep_graph_ms=sweep,
                            blocks_per_sm=resident if D == 128 else None,
                            device_launches_per_call=dev_launches,
                            tb_s=nbytes / ms / 1e9, S=S, H=H, KVH=KVH, D=D,
                            live_tokens=int(lens_np.sum()))
    return result


# -- phase 4: the int8 kernel ----------------------------------------------------

# llama3-8b's int8 products (K, N, out dtype) and how many a decode step runs
INT8_SHAPES = [
    ("wq, wo: 4096->4096", 4096, 4096, "bf16", 2 * LLAMA3_8B["layers"]),
    ("wk, wv: 4096->1024", 4096, 1024, "bf16", 2 * LLAMA3_8B["layers"]),
    ("w_gate, w_up: 4096->14336", 4096, 14336, "bf16", 2 * LLAMA3_8B["layers"]),
    ("w_down: 14336->4096", 14336, 4096, "bf16", LLAMA3_8B["layers"]),
    ("lm_head: 4096->128256", 4096, 128256, "fp32", 1),
]
INT8_LAUNCHES_PER_STEP = sum(n for *_, n in INT8_SHAPES)  # 7 per layer x 32 + 1 = 225
# llama3-70b's (phase 19), and one tp=2 rank's at llama3-8b widths (phase
# 16's "int8-all" serve: a rank's vocab shard for the LM head)
INT8_70B_SHAPES = [
    ("70b wq, wo: 8192->8192", 8192, 8192, "bf16", 2 * LLAMA3_70B["layers"]),
    ("70b wk, wv: 8192->1024", 8192, 1024, "bf16", 2 * LLAMA3_70B["layers"]),
    ("70b w_gate, w_up: 8192->28672", 8192, 28672, "bf16", 2 * LLAMA3_70B["layers"]),
    ("70b w_down: 28672->8192", 28672, 8192, "bf16", LLAMA3_70B["layers"]),
    ("70b lm_head: 8192->128256", 8192, 128256, "fp32", 1),
]
INT8_70B_PER_STEP = sum(n for *_, n in INT8_70B_SHAPES)  # 7 per layer x 80 + 1 = 561
INT8_TP2_SHAPES = [
    ("8b tp=2 rank wq: 4096->2048", 4096, 2048, "bf16", LLAMA3_8B["layers"]),
    ("8b tp=2 rank wk, wv: 4096->512", 4096, 512, "bf16", 2 * LLAMA3_8B["layers"]),
    ("8b tp=2 rank wo: 2048->4096", 2048, 4096, "bf16", LLAMA3_8B["layers"]),
    ("8b tp=2 rank w_gate, w_up: 4096->7168", 4096, 7168, "bf16", 2 * LLAMA3_8B["layers"]),
    ("8b tp=2 rank w_down: 7168->4096", 7168, 4096, "bf16", LLAMA3_8B["layers"]),
    ("8b tp=2 rank lm_head: 4096->64128", 4096, 64128, "fp32", 1),
]
# the rows of those shapes: a decode step at 8 lanes, a 1024-row prefill chunk
INT8_NEW_M = (8, 1024)
# a lone user, the slice's 8 lanes, and a speculative verify dispatch of 8
# lanes x (k + 1) positions at k = 4
INT8_DECODE_M = (1, 8, 40)
SPEC_K = 4
# prefill rows of one shape: up to an "int8-all" chunk of 8 lanes x 128 tokens
INT8_PREFILL = ("w_gate, w_up: 4096->14336", 4096, 14336, (64, 256, 1024))
# both kernels forced at these M, to place the planner's choice between them
INT8_SWEEP_SHAPES = ((4096, 14336), (4096, 4096))
INT8_SWEEP_M = (32, 64, 128, 256, 512)
# (x dtype, max|d| / max|ref| allowed): a bf16 product may differ by one
# bf16 ulp of an element where kernel and plain version sum in other orders;
# with fp32 activations only the order of the fp32 sums differs
INT8_TOL = {"bf16": 1e-2, "fp32": 1e-5}


def int8_bound(M, N, K, out_bytes, rate):
    """(bound_ms, bound_by) of one product: x, q, s read once and out
    written once at the HBM rate, or 2·M·N·K operations at the bf16 peak."""
    nbytes = M * K * 2 + N * K + N * 4 + M * N * out_bytes
    t_bytes, t_ops = nbytes / rate, 2 * M * N * K / BF16_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def plan_label(plan) -> str:
    return (f"{plan.path} kernel, {plan.rows} weight rows x {plan.lanes} lanes per block, "
            f"{plan.splits} splits, {plan.blocks} blocks")


def int8_inputs(torch, gen, K, N, M, xdt):
    """x [M, K] and as many int8 weights [N, K] with scales as make 120 MB
    or more (cycled through, they are not in L2)."""
    n_sets = min(MAX_SETS, max(1, -(-int(COLD_BYTES) // (N * K))))
    qs = [torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
          for _ in range(n_sets)]
    ss = [torch.rand(N, generator=gen, device="cuda") * 2e-3 + 1e-4 for _ in range(n_sets)]
    x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
    return x, qs, ss


def time_int8(torch, fn, x, qs, ss, out_dtype, **kw):
    """(eager ms, graph-replayed ms) of ``fn`` cycling through the weights."""
    calls = [lambda q=q, s_=s_: fn(x, q, s_, out_dtype=out_dtype, **kw) for q, s_ in zip(qs, ss)]
    return time_many(torch, calls), time_graph(torch, calls)


def phase_int8_kernel(card: str) -> dict:
    import torch

    from dynamo_tpu_torch.ops.int8_matmul import (
        int8_weight_matmul,
        int8_weight_matmul_plain,
        plan_int8,
    )

    rate = hbm_rate(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [(name, K, N, out, M, "bf16") for name, K, N, out, _ in INT8_SHAPES
             for M in INT8_DECODE_M]
    cases += [(f"{INT8_PREFILL[0]} ({'int8-all prefill chunk' if M == 1024 else 'prefill'})",
               INT8_PREFILL[1], INT8_PREFILL[2], "bf16", M, "bf16") for M in INT8_PREFILL[3]]
    cases += [("wq, wo: 4096->4096 (fp32 activations)", 4096, 4096, "fp32", 8, "fp32")]
    cases += [(name, K, N, out, M, "bf16") for shapes in (INT8_70B_SHAPES, INT8_TP2_SHAPES)
              for name, K, N, out, _ in shapes for M in INT8_NEW_M]
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    result = []
    for name, K, N, out, M, xdt in cases:
        out_dtype = dt[out]
        x, qs, ss = int8_inputs(torch, gen, K, N, M, dt[xdt])
        plan = plan_int8(M, N, K, sms)
        before = int8_weight_matmul.launches
        got = int8_weight_matmul(x, qs[0], ss[0], out_dtype=out_dtype)
        torch.cuda.synchronize()
        if int8_weight_matmul.launches != before + 1:
            fail(f"int8_weight_matmul [{name}, M={M}] did not count its launch")
        kernel, blocks, splits = int8_weight_matmul.last_launch
        ref = int8_weight_matmul_plain(x, qs[0], ss[0], out_dtype=out_dtype).float()
        err = (got.float() - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        ok = bool(torch.isfinite(got.float()).all()) and rel <= INT8_TOL[xdt]
        print(f"int8 kernel vs plain [{name}, M={M}, x {xdt}, out {out}; {kernel}, {blocks} "
              f"blocks, {splits} splits]: max|d| {err:.3e}, max|d|/max|ref| {rel:.3e} (limit "
              f"{INT8_TOL[xdt]:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"int8_weight_matmul disagrees with its plain version: {name} M={M}")
        if xdt == "bf16" and (kernel != f"w8a16_{plan.path}_kernel"
                              or (blocks, splits) != (plan.blocks, plan.splits)):
            fail(f"int8_weight_matmul [{name}, M={M}] launched {kernel} ({blocks} blocks, "
                 f"{splits} splits), not its plan: {plan}")
        row = dict(name=name, M=M, K=K, N=N, x=xdt, out=out, max_abs_err=err, rel_err=rel,
                   kernel=kernel, blocks=blocks, splits=splits)
        if xdt == "bf16":
            print(f"  plan [{name}, M={M}]: {plan_label(plan)}")
            b_ms, b_by = int8_bound(M, N, K, 4 if out == "fp32" else 2, rate)
            ms, graph_ms = time_int8(torch, int8_weight_matmul, x, qs, ss, out_dtype)
            plain_ms = time_many(torch, [lambda: int8_weight_matmul_plain(
                x, qs[0], ss[0], out_dtype=out_dtype)], calls=8 if N * K > 1e8 else 30, reps=1)
            cold = len(qs) * N * K > 100e6
            del qs, ss
            # the library yardstick: the bf16 engine's product, x @ w with w
            # [K, N] bf16, cycled through as many bytes
            n_lib = min(MAX_SETS, max(1, -(-int(COLD_BYTES) // (2 * N * K))))
            ws = [torch.randn((K, N), generator=gen, device="cuda").bfloat16()
                  for _ in range(n_lib)]
            lib = [lambda w=w: torch.matmul(x, w) for w in ws]
            lib_ms, lib_graph_ms = time_many(torch, lib), time_graph(torch, lib)
            del ws, lib
            torch.cuda.empty_cache()
            print(f"  time [{name}, M={M}]: kernel {ms:.4f} ms ({b_ms / ms:.1%} of the "
                  f"{b_by} bound), graph-replayed {graph_ms:.4f} ms ({b_ms / graph_ms:.1%}), "
                  f"eager - graph {1e3 * (ms - graph_ms):.1f} us, bound {b_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (bf16 torch.matmul, [{K}, {N}] bf16 weight) "
                  f"{lib_ms:.4f} ms, graph-replayed {lib_graph_ms:.4f} ms")
            row.update(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_graph_ms=lib_graph_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / ms, bound_share_graph=b_ms / graph_ms, cold_l2=cold,
                       plan=dataclasses.asdict(plan))
        result.append(row)
        torch.cuda.empty_cache()
    # both kernels forced on either side of the planner's threshold
    sweep = []
    for K, N in INT8_SWEEP_SHAPES:
        for M in INT8_SWEEP_M:
            x, qs, ss = int8_inputs(torch, gen, K, N, M, torch.bfloat16)
            times = {path: time_int8(torch, int8_weight_matmul, x, qs, ss, torch.bfloat16,
                                     plan=plan_int8(M, N, K, sms, path=path))[1]
                     for path in ("splitk", "tile")}
            del x, qs, ss
            sweep.append(dict(K=K, N=N, M=M, **{f"{p}_graph_ms": t for p, t in times.items()}))
            print(f"  kernels forced [{K}->{N}, M={M}, graph-replayed]: split-K "
                  f"{times['splitk']:.4f} ms, tile {times['tile']:.4f} ms (the plan takes "
                  f"{plan_int8(M, N, K, sms).path})")
    torch.cuda.empty_cache()
    # one forward's launches over its shapes: a llama3-8b decode step at M =
    # 8 and a verify dispatch at M = 40 (225 launches); a llama3-70b decode
    # step and prefill chunk (561); one tp=2 rank's decode step and chunk
    # (225). A chunk's LM head runs on the 8 sampled rows, as the engine's
    # chunk dispatch runs it
    keys = ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms", "bound_ms")
    sums = {}
    for key_, shapes, M, label in (
            (8, INT8_SHAPES, 8, "decode step"),
            (8 * (SPEC_K + 1), INT8_SHAPES, 8 * (SPEC_K + 1), "verify dispatch"),
            ("70b step", INT8_70B_SHAPES, 8, "llama3-70b decode step"),
            ("70b chunk", INT8_70B_SHAPES, 1024, "llama3-70b prefill chunk"),
            ("tp2 step", INT8_TP2_SHAPES, 8, "llama3-8b tp=2 decode step, one rank"),
            ("tp2 chunk", INT8_TP2_SHAPES, 1024, "llama3-8b tp=2 prefill chunk, one rank")):
        total = {key: 0.0 for key in keys}
        for name, K, N, out, count in shapes:
            m = 8 if "lm_head" in name and M == 1024 else M
            (row,) = [r for r in result if r["name"] == name and r["M"] == m and r["x"] == "bf16"]
            for key in keys:
                total[key] += count * row[key]
        total["bound_share"] = total["bound_ms"] / total["ms"]
        total["bound_share_graph"] = total["bound_ms"] / total["graph_ms"]
        total["launches"] = sum(n for *_, n in shapes)
        print(f"int8 {label} (M={M}, {total['launches']} launches): kernel "
              f"{total['ms']:.3f} ms ({total['bound_share']:.1%} of the bound), "
              f"graph-replayed {total['graph_ms']:.3f} ms ({total['bound_share_graph']:.1%}), "
              f"bound {total['bound_ms']:.3f} ms, bf16 torch.matmul {total['library_ms']:.3f} ms "
              f"(graph-replayed {total['library_graph_ms']:.3f} ms), plain "
              f"{total['plain_ms']:.3f} ms, on {card}")
        sums[key_] = total
    return {"cases": result, "per_step": sums[8], "per_verify": sums[8 * (SPEC_K + 1)],
            "sweep": sweep, "step_70b": sums["70b step"], "chunk_70b": sums["70b chunk"],
            "step_tp2": sums["tp2 step"], "chunk_tp2": sums["tp2 chunk"]}


# -- phase 5: the expert kernel --------------------------------------------------

# mixtral-8x7b's expert products (K, N) and how many a decode step runs
EXPERT_SHAPES = [
    ("w_gate, w_up: 4096->14336", 4096, 14336, 2 * MIXTRAL["layers"]),
    ("w_down: 14336->4096", 14336, 4096, MIXTRAL["layers"]),
]
EXPERT_LAUNCHES_PER_STEP = sum(n for *_, n in EXPERT_SHAPES)  # 3 per layer x 32 = 96
# one tp=2 rank's expert stacks (phase 20: every expert at F/2), per rank
# and forward as many as above
EXPERT_TP2_SHAPES = [
    ("tp=2 rank w_gate, w_up: 4096->7168", 4096, 7168, 2 * MIXTRAL["layers"]),
    ("tp=2 rank w_down: 7168->4096", 7168, 4096, MIXTRAL["layers"]),
]
# rows per expert: decode at 8 lanes (C = 4) and its neighbours, an odd C,
# a short prefill's 17, and a 1024-row prefill chunk's 512 and 130 (one
# ragged token tile)
EXPERT_C = (2, 4, 5, 17, 130, 512)
# the split-K and expert tile kernels forced at these C, to place the
# planner's cut between them (EXPERT_TILE_MIN_C)
EXPERT_SWEEP_C = (4, 5, 8, 12, 17, 24, 32)
# bf16 outputs round twice (the product, then the scaled output): up to two
# bf16 ulps of the max, 2^-6 of it
EXPERT_TOL = 2.0 ** -6


def expert_bound(X, C, N, K, rate):
    """(bound_ms, bound_by) of one stack: x, q, s read once and out written
    once at the HBM rate, or 2·X·C·N·K operations at the bf16 peak."""
    nbytes = X * (C * K * 2 + N * K + N * 4 + C * N * 2)
    t_bytes, t_ops = nbytes / rate, 2 * X * C * N * K / BF16_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def expert_plain64(x, q, s):
    """The plain expert product summed in fp64, then the kernel's two
    roundings as the plain version makes them: the yardstick of both
    accumulation orders."""
    import torch

    return torch.stack([((x[e].double() @ q[e].double().T).to(x.dtype).float() * s[e])
                        .to(x.dtype) for e in range(q.shape[0])])


def drift(got, ref) -> dict:
    """max|d| / max|ref| and the share of outputs that are not bit-equal."""
    d = (got.float() - ref.float()).abs()
    return {"rel": d.max().item() / max(ref.float().abs().max().item(), 1e-30),
            "differ_share": (d > 0).float().mean().item()}


@contextmanager
def card_clocks(into: list):
    """Sample the card's SM clock (MHz) and power draw (W) with nvidia-smi
    every 0.2 s while the block runs, into ``into`` as (MHz, W) pairs."""
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True)
            try:
                mhz, watts = res.stdout.strip().splitlines()[0].split(",")
                into.append((float(mhz), float(watts)))
            except (IndexError, ValueError):
                pass
            stop.wait(0.2)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


def phase_expert_kernel(card: str) -> dict:
    """``int8_expert_matmul`` over 8 experts at mixtral-8x7b's two expert
    shapes and C = 2, 4, 5, 17, 130 and 512: the plan and the launch it made,
    the planned kernel and the expert tile kernel (forced where the plan
    takes split-K) held against the plain version; each one's drift from the
    plain product summed in fp64 beside the fp32 plain product's; eager and
    graph-replayed ms over two stacks (940 MB, far past L2) of the planned
    kernel, graph-replayed ms of the expert tile kernel, the dense tile kernel
    and the split-K kernel forced, the bound, the plain version and bf16
    ``torch.bmm`` over a bf16 [8, K, N] stack on the same activations; then
    both kernels forced across the planner's cut, and the expert products
    of a 1024-row prefill chunk (96 stacks at C = 512)."""
    import torch

    from dynamo_tpu_torch.ops.int8_matmul import (
        EXPERT_TILE_MIN_C,
        int8_expert_matmul,
        int8_expert_matmul_plain,
        plan_int8,
    )

    X = MIXTRAL["experts"]
    rate = hbm_rate(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(11)
    result, sweep = [], []
    # mixtral's stacks at every C with the sweep; a tp=2 rank's at decode
    # and prefill-chunk C
    stacks = [(*shape, EXPERT_C, EXPERT_SWEEP_C) for shape in EXPERT_SHAPES]
    stacks += [(*shape, (4, 512), ()) for shape in EXPERT_TP2_SHAPES]
    for name, K, N, _, c_values, sweep_c in stacks:
        qs = [torch.randint(-127, 128, (X, N, K), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(2)]
        ss = [torch.rand((X, N), generator=gen, device="cuda") * 2e-3 + 1e-4 for _ in range(2)]
        ws = [torch.randn((X, K, N), generator=gen, device="cuda").bfloat16() for _ in range(2)]
        for C in c_values:
            x = torch.randn((X, C, K), generator=gen, device="cuda").bfloat16()
            plan = plan_int8(C, N, K, sms, experts=X)
            forced = {p: plan_int8(C, N, K, sms, path=p, experts=X)
                      for p in ("expert_tile", "tile", "splitk")}
            before = int8_expert_matmul.launches
            got = int8_expert_matmul(x, qs[0], ss[0])
            torch.cuda.synchronize()
            if int8_expert_matmul.launches != before + 1:
                fail(f"int8_expert_matmul [{name}, C={C}] did not count its launch")
            kernel, blocks, splits = int8_expert_matmul.last_launch
            if kernel != plan.kernel or (blocks, splits) != (plan.blocks, plan.splits):
                fail(f"int8_expert_matmul [{name}, C={C}] launched {kernel} ({blocks} blocks, "
                     f"{splits} splits), not its plan: {plan}")
            ref = int8_expert_matmul_plain(x, qs[0], ss[0])
            ref64 = expert_plain64(x, qs[0], ss[0])
            outs = {plan.path: got}
            if plan.path != "expert_tile":
                outs["expert_tile"] = int8_expert_matmul(x, qs[0], ss[0],
                                                         plan=forced["expert_tile"])
                torch.cuda.synchronize()
            row = dict(name=name, X=X, C=C, K=K, N=N, kernel=kernel, blocks=blocks, splits=splits,
                       plan=dataclasses.asdict(plan),
                       plain_fp32_vs_fp64=drift(ref, ref64))
            for path, out in outs.items():
                err = (out.float() - ref.float()).abs().max().item()
                rel = err / max(ref.float().abs().max().item(), 1e-30)
                ok = bool(torch.isfinite(out.float()).all()) and rel <= EXPERT_TOL
                d64 = drift(out, ref64)
                print(f"expert kernel vs plain [{name}, {X} experts, C={C}; "
                      f"{forced[path].kernel}{'' if path == plan.path else ' (forced)'}, "
                      f"{forced[path].blocks} blocks, {forced[path].splits} splits]: max|d| "
                      f"{err:.3e}, max|d|/max|ref| {rel:.3e} (limit {EXPERT_TOL:g}) "
                      f"{'ok' if ok else 'MISMATCH'}; against the fp64 plain product "
                      f"{d64['rel']:.3e} ({d64['differ_share']:.2%} of outputs differ), the fp32 "
                      f"plain product {row['plain_fp32_vs_fp64']['rel']:.3e} "
                      f"({row['plain_fp32_vs_fp64']['differ_share']:.2%})")
                if not ok:
                    fail(f"int8_expert_matmul [{path}] disagrees with its plain version: "
                         f"{name} C={C}")
                row[f"{path}_max_abs_err"] = err
                row[f"{path}_rel_err"] = rel
                row[f"{path}_vs_fp64"] = d64
            row["max_abs_err"] = row[f"{plan.path}_max_abs_err"]
            row["rel_err"] = row[f"{plan.path}_rel_err"]
            print(f"  plan [{name}, C={C}]: {plan_label(plan)}")
            b_ms, b_by = expert_bound(X, C, N, K, rate)
            calls = [lambda q=q, s_=s_: int8_expert_matmul(x, q, s_) for q, s_ in zip(qs, ss)]
            clocks = []
            with card_clocks(clocks) if C == 512 else nullcontext():
                ms, graph_ms = time_many(torch, calls), time_graph(torch, calls)
            paths_ms = {path: graph_ms if path == plan.path else time_graph(torch, [
                lambda q=q, s_=s_, p=p: int8_expert_matmul(x, q, s_, plan=p)
                for q, s_ in zip(qs, ss)]) for path, p in forced.items()}
            if clocks:
                mhz = sorted(c[0] for c in clocks)
                watts = sorted(c[1] for c in clocks)
                row["clocks_mhz"], row["power_w"] = mhz, watts
                print(f"  card while the planned kernel ran [{name}, C={C}]: SM clock "
                      f"{mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median {statistics.median(mhz):.0f}), "
                      f"power {watts[0]:.1f}-{watts[-1]:.1f} W, {len(clocks)} nvidia-smi samples")
            plain_ms = time_many(torch, [lambda: int8_expert_matmul_plain(x, qs[0], ss[0])],
                                 calls=4, reps=1)
            lib = [lambda w=w: torch.bmm(x, w) for w in ws]
            lib_ms, lib_graph_ms = time_many(torch, lib), time_graph(torch, lib)
            print(f"  time [{name}, C={C}]: kernel {ms:.4f} ms ({b_ms / ms:.1%} of the {b_by} "
                  f"bound), graph-replayed {graph_ms:.4f} ms ({b_ms / graph_ms:.1%}), bound "
                  f"{b_ms:.4f} ms, plain {plain_ms:.4f} ms, library (bf16 torch.bmm, [{X}, {K}, "
                  f"{N}] bf16 stack) {lib_ms:.4f} ms, graph-replayed {lib_graph_ms:.4f} ms; "
                  f"graph-replayed, each kernel forced: expert tile "
                  f"{paths_ms['expert_tile']:.4f} ms, dense tile {paths_ms['tile']:.4f} ms, "
                  f"split-K {paths_ms['splitk']:.4f} ms")
            row.update(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_graph_ms=lib_graph_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / ms, bound_share_graph=b_ms / graph_ms,
                       **{f"{p}_graph_ms": t for p, t in paths_ms.items()})
            result.append(row)
            del x, got, ref, ref64, outs
        # both kernels forced across the planner's cut
        for C in sweep_c:
            x = torch.randn((X, C, K), generator=gen, device="cuda").bfloat16()
            times = {p: time_graph(torch, [
                lambda q=q, s_=s_, pl=plan_int8(C, N, K, sms, path=p, experts=X):
                int8_expert_matmul(x, q, s_, plan=pl) for q, s_ in zip(qs, ss)])
                for p in ("splitk", "expert_tile")}
            sweep.append(dict(K=K, N=N, C=C, **{f"{p}_graph_ms": t for p, t in times.items()}))
            print(f"  kernels forced [{name}, C={C}, graph-replayed]: split-K "
                  f"{times['splitk']:.4f} ms, expert tile {times['expert_tile']:.4f} ms (the plan "
                  f"takes {plan_int8(C, N, K, sms, experts=X).path}; cut at C = "
                  f"{EXPERT_TILE_MIN_C})")
            del x
        del qs, ss, ws
        torch.cuda.empty_cache()
    # one mixtral decode step at C = 4 (96 launches), and the expert products
    # of a 1024-row prefill chunk at C = 512 (96 launches), over the two shapes
    keys = ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms", "bound_ms",
            "expert_tile_graph_ms", "tile_graph_ms", "splitk_graph_ms")
    units = {}
    for shapes, C in ((EXPERT_SHAPES, 4), (EXPERT_SHAPES, 512), (EXPERT_TP2_SHAPES, 4),
                      (EXPERT_TP2_SHAPES, 512)):
        unit = {key: 0.0 for key in keys}
        for name, K, N, count in shapes:
            (row,) = [r for r in result if r["name"] == name and r["C"] == C]
            for key in keys:
                unit[key] += count * row[key]
        unit["bound_share"] = unit["bound_ms"] / unit["ms"]
        unit["bound_share_graph"] = unit["bound_ms"] / unit["graph_ms"]
        units[shapes is EXPERT_TP2_SHAPES, C] = unit
    per_step, chunk = units[False, 4], units[False, 512]
    for C, label in ((4, "decode step (C=4)"), (512, "1024-row prefill chunk (C=512)")):
        u = units[True, C]
        print(f"expert tp=2 rank, one mixtral {label}, {EXPERT_LAUNCHES_PER_STEP} launches at "
              f"F/2: kernel {u['ms']:.3f} ms ({u['bound_share']:.1%} of the bound), "
              f"graph-replayed {u['graph_ms']:.3f} ms, bound {u['bound_ms']:.3f} ms, bf16 "
              f"torch.bmm {u['library_ms']:.3f} ms, plain {u['plain_ms']:.3f} ms, on {card}")
    print(f"expert decode step (C=4, {EXPERT_LAUNCHES_PER_STEP} launches): kernel "
          f"{per_step['ms']:.3f} ms ({per_step['bound_share']:.1%} of the bound), "
          f"graph-replayed {per_step['graph_ms']:.3f} ms ({per_step['bound_share_graph']:.1%}), "
          f"bound {per_step['bound_ms']:.3f} ms, bf16 torch.bmm {per_step['library_ms']:.3f} ms "
          f"(graph-replayed {per_step['library_graph_ms']:.3f} ms), plain "
          f"{per_step['plain_ms']:.3f} ms, on {card}")
    print(f"expert products of a 1024-row prefill chunk (C=512, {EXPERT_LAUNCHES_PER_STEP} "
          f"launches): expert tile kernel {chunk['ms']:.3f} ms ({chunk['bound_share']:.1%} of "
          f"the bound), graph-replayed {chunk['graph_ms']:.3f} ms "
          f"({chunk['bound_share_graph']:.1%}); the dense tile kernel graph-replayed "
          f"{chunk['tile_graph_ms']:.3f} ms; bound {chunk['bound_ms']:.3f} ms; bf16 torch.bmm "
          f"{chunk['library_ms']:.3f} ms (graph-replayed {chunk['library_graph_ms']:.3f} ms); "
          f"plain {chunk['plain_ms']:.3f} ms, on {card}")
    return {"cases": result, "per_step": per_step, "prefill_chunk": chunk, "sweep": sweep,
            "step_tp2": units[True, 4], "chunk_tp2": units[True, 512]}


# -- the HTTP pipeline (phases 6, 7, 9, 11, 12 and 13) ----------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stream(port: int, path: str, body: dict, t_sent: list, i: int,
            headers: dict = None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t_sent[i] = time.perf_counter()
    conn.request("POST", path, json.dumps(body),
                 dict({"Content-Type": "application/json"}, **(headers or {})))
    resp = conn.getresponse()
    out = {"status": resp.status, "finish": None, "usage": None, "text": "", "end": None}
    if resp.status != 200:
        out["error"] = resp.read().decode(errors="replace")
        return out
    buf = b""
    while True:
        piece = resp.read1(65536) if hasattr(resp, "read1") else resp.read(65536)
        if not piece:
            break
        buf += piece
    out["end"] = time.perf_counter()
    for frame in buf.decode().split("\n\n"):
        if not frame.startswith("data: ") or frame == "data: [DONE]":
            continue
        chunk = json.loads(frame[len("data: "):])
        for ch in chunk.get("choices", []):
            if ch.get("finish_reason"):
                out["finish"] = ch["finish_reason"]
            out["text"] += (ch.get("delta") or {}).get("content") or ch.get("text") or ""
        if chunk.get("usage"):
            out["usage"] = chunk["usage"]
    out["done"] = buf.rstrip().endswith(b"data: [DONE]")
    conn.close()
    return out


def _wait_until(cond, threads, timeout_s: float = 300.0) -> None:
    """Poll ``cond`` until it holds, every request thread has ended, or the
    time runs out."""
    deadline = time.perf_counter() + timeout_s
    while not cond() and any(t.is_alive() for t in threads):
        if time.perf_counter() > deadline:
            fail("profile: the decode dispatches did not advance")
        time.sleep(0.002)


def device_intervals_us(trace_path: str):
    """(kernel events, every device event) of a chrome trace from
    torch.profiler: dicts with name, ts and dur in µs."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X" and "dur" in e
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return [e for e in dev if e.get("cat") == "kernel"], dev


# names of the port's kernels in a device trace, by wrapper; the int8 kernels
# serve int8_weight_matmul and int8_expert_matmul alike
TRACE_KERNELS = {"paged_decode_attention": ("paged_decode_split_kernel",
                                            "paged_decode_merge_kernel"),
                 "paged_decode_attention_int8": ("paged_decode_int8_split_kernel",),
                 "int8_weight_matmul": ("w8a16_tile_kernel", "w8a16_splitk_kernel",
                                        "w8f32_kernel")}


# the dispatch gate's kernel (csrc/dispatch_gate.cu): a wait, not work
GATE_KERNEL = "dispatch_gate_wait_kernel"
# inside a gated segment the card runs the kernels back to back; a longer gap
# ends the segment (what follows was enqueued after the timer's end)
SEGMENT_GAP_US = 20.0
# within a dispatch the next gate is queued before the segment ahead of it
# ends; between dispatches the card waits for the host to finish one
# dispatch and build the next
DISPATCH_GAP_US = 200.0


def dispatch_device_times(trace_path: str, calls: list, gates: tuple) -> dict:
    """Each timed decode dispatch of ``calls`` (:func:`profile_decode`) as
    the card ran it, read from the torch.profiler trace on the device side
    alone. Each gate opens a segment: the chain of device events that
    starts as the gate ends and runs back to back (gaps under
    SEGMENT_GAP_US) until the next gate, what the engine's event pair
    around the segment times. A gate that starts more than DISPATCH_GAP_US
    after the segment before it ended starts a dispatch (every dispatch
    boundary is one, and a host stall may add some). The timed dispatches
    launched while the profiler ran (``gates``: the process's gate count
    at its start and stop; a call's gates are launches ``g0 - 1`` to
    ``g1 - 1``) take the trace's dispatches in order, and a decode call
    counts when it got all of its gates. Returns, per such call (under
    "dispatches"): its number, its
    gates, the sum of its segments (``span_us``: what the engine's device
    time measures), the union of their events (``busy_us``: the profiler's
    device time) and the sum of their durations, and its first gate's
    start; the numbers of every timed dispatch of ``calls`` (under
    "timed_calls"); the gates the trace holds, the gates launched while it
    ran, and the dispatches each side counts; and the device's idle share
    from the first pair's first gate to the last one's (one minus the union
    of every device event but the gates' over that interval), the interval
    over which the engine's ``device_idle_frac`` of the same dispatches
    runs."""
    import bisect

    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = sorted((e for e in events if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    gate_evs = [e for e in dev if GATE_KERNEL in e["name"]]
    work = [e for e in dev if GATE_KERNEL not in e["name"]]
    starts = [e["ts"] for e in work]
    # each gate's segment: (start, end, busy, sum of durations)
    segs = []
    for j, g in enumerate(gate_evs):
        a = g["ts"] + g["dur"]
        bound = gate_evs[j + 1]["ts"] if j + 1 < len(gate_evs) else float("inf")
        end, busy, ksum = a, 0.0, 0.0
        i = bisect.bisect_left(starts, a - 1.0)
        while i < len(work) and work[i]["ts"] < bound and work[i]["ts"] <= end + SEGMENT_GAP_US:
            e = work[i]
            busy += max(0.0, e["ts"] + e["dur"] - max(e["ts"], end))
            ksum += e["dur"]
            end = max(end, e["ts"] + e["dur"])
            i += 1
        segs.append((a, end, busy, ksum))
    groups = []  # runs of gate indices, one per dispatch
    for j, g in enumerate(gate_evs):
        if j == 0 or g["ts"] - segs[j - 1][1] > DISPATCH_GAP_US:
            groups.append([])
        groups[-1].append(j)
    g_start, g_end = gates
    # the timed dispatches launched while the profiler ran, in order: each
    # takes the trace's next dispatches while their gates fit in its count
    # (a host stall inside a dispatch can split it; a gate the trace lost
    # leaves it short)
    window = [c for c in calls if c["timed"] and c["g0"] - 1 >= g_start and c["g1"] <= g_end]
    out, k = [], 0
    for call in window:
        want, got = call["g1"] - call["g0"] + 1, []
        while k < len(groups) and len(got) + len(groups[k]) <= want:
            got += groups[k]
            k += 1
        if call["kind"] != "decode" or len(got) != want:
            continue
        parts = [segs[j] for j in got]
        out.append({"n": call["n"], "gates": want,
                    "span_us": sum(p[1] - p[0] for p in parts),
                    "busy_us": sum(p[2] for p in parts),
                    "kernel_sum_us": sum(p[3] for p in parts),
                    "t0": gate_evs[got[0]]["ts"]})
    idle = None
    if len(out) >= 2:
        t0, t1 = out[0]["t0"], out[-1]["t0"]
        busy, end = 0.0, t0
        for e in work:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if a < b and b > end:
                busy += b - max(a, end)
                end = b
        idle = max(0.0, 1.0 - busy / (t1 - t0))
    return {"dispatches": out, "idle_share": idle, "gates_in_trace": len(gate_evs),
            "gates_launched": g_end - g_start, "trace_dispatches": [len(g) for g in groups],
            "window_calls": len(window),
            "timed_calls": [c["n"] for c in calls if c["timed"] and c["kind"] == "decode"]}


def expert_event(e) -> bool:
    """An int8 kernel event launched by int8_expert_matmul: its grid's z is
    the expert axis (8 at mixtral's shapes), 1 for every llama-family
    int8_weight_matmul launch on the serving path (M <= 64 on split-K, the
    tile kernel's z is 1)."""
    grid = (e.get("args") or {}).get("grid") or [1, 1, 1]
    return any(k in e["name"] for k in TRACE_KERNELS["int8_weight_matmul"]) and grid[2] > 1


def warm_profiler() -> float:
    """Start and stop torch.profiler once on a small CUDA op, before any
    engine thread launches work: its first start takes seconds (CUPTI), which
    would otherwise eat the profiled window. Returns those seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_decode(port: int, bodies: list, core, quiesce=nullcontext,
                   dispatches: int = PROFILE_DISPATCHES, trace_hook=None) -> dict:
    """torch.profiler (CPU and CUDA) over ``dispatches`` steady decode
    dispatches of a second wave of the same requests, PROFILE_TOKENS long.
    Prints the top device kernels, each port kernel's share of device time,
    the paged decode kernels' device events per wrapper call in the window,
    and the device's idle share of the window (host clock); prints "not
    measured" when the profiler records no device activity. The dispatch
    gate's spins (the profiling plane's device timer holding the stream
    for the host) are waits, not work: they count neither as kernels nor
    as busy time; ``quiesce()`` is entered around the profiler's start and
    stop (phase 21: no dispatch is gated then).
    ``trace_hook(trace_path, calls, gates)``, when given, reads the trace
    before it is deleted and its result is returned under "trace":
    ``calls`` holds, per chunk and decode dispatch of the wave, its number,
    its kind, whether the device timer timed it, and the count of dispatch
    gates launched so far at its start and at its end (the process's
    count); ``gates`` is
    that count when the profiler started and when it stopped, each read
    with the card drained, so that the trace holds exactly the gates
    launched in between."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.ops.dispatch_gate import dispatch_gate_wait

    from dynamo_tpu_torch.ops.int8_matmul import int8_expert_matmul, int8_weight_matmul
    from dynamo_tpu_torch.ops.paged_attention import (
        device_launches,
        paged_decode_attention,
        paged_decode_attention_int8,
        paged_decode_attention_sharded,
    )
    from dynamo_tpu_torch.parallel.collectives import all_gather, all_reduce

    def counts():
        return dict(device_launches, sharded=paged_decode_attention_sharded.launches,
                    all_reduce=all_reduce.calls, all_gather=all_gather.calls)

    bodies = [(path, dict(body, max_tokens=PROFILE_TOKENS)) for path, body in bodies]
    results = [None] * len(bodies)
    t_sent = [0.0] * len(bodies)

    def run_one(i):
        results[i] = _stream(port, bodies[i][0], bodies[i][1], t_sent, i)

    threads = [threading.Thread(target=run_one, args=(i,)) for i in range(len(bodies))]
    # the counts at each decode dispatch's start, taken on the engine thread
    # right before the dispatch launches anything (every launch before it is
    # the earlier dispatches'): per-step counts between two such marks are
    # exact, where a read from this thread may land in mid-dispatch
    marks, window, dispatch_calls = [], [False], []
    # one wrapper per variant: the engine knows a step function by it
    wrapped = {}

    def wrap(kind, build):
        def marked(*key):
            if (kind, key) not in wrapped:
                fn = build(*key)

                def dispatch(*a, **kw):
                    if window[0] and kind == "decode":
                        marks.append((core.decode_steps_total, counts()))
                    g0 = dispatch_gate_wait.launches
                    out = fn(*a, **kw)
                    # the device timer passes layer_hook only to a dispatch
                    # it times, and has launched its first gate before
                    dispatch_calls.append({"n": len(dispatch_calls), "kind": kind,
                                           "timed": "layer_hook" in kw, "g0": g0,
                                           "g1": dispatch_gate_wait.launches})
                    return out
                wrapped[(kind, key)] = dispatch
            return wrapped[(kind, key)]
        return marked

    core._decode = wrap("decode", core._decode)
    core._chunk = wrap("chunk", core._chunk)
    d0 = core.decode_dispatches
    for t in threads:
        t.start()
    try:
        _wait_until(lambda: core.decode_dispatches >= d0 + 2, threads)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        gates = [0, 0]
        with quiesce():
            if trace_hook is not None:
                torch.cuda.synchronize()
            prof.start()
            gates[0] = dispatch_gate_wait.launches
        t0 = time.perf_counter()
        w0 = time.time()
        window[0] = True
        d1, s1 = core.decode_dispatches, core.decode_steps_total
        c1, i1 = paged_decode_attention.launches, int8_weight_matmul.launches
        x1, q1 = int8_expert_matmul.launches, paged_decode_attention_int8.launches
        _wait_until(lambda: core.decode_dispatches >= d1 + dispatches, threads)
        window[0] = False
        d2, s2 = core.decode_dispatches, core.decode_steps_total
        calls = paged_decode_attention.launches - c1
        kv8_calls = paged_decode_attention_int8.launches - q1
        int8_calls = int8_weight_matmul.launches - i1
        expert_calls = int8_expert_matmul.launches - x1
        window_us = (time.perf_counter() - t0) * 1e6
        w1 = time.time()
        with quiesce():
            if trace_hook is not None:
                torch.cuda.synchronize()
            gates[1] = dispatch_gate_wait.launches
            prof.stop()
    finally:
        del core._decode, core._chunk  # the engine's own methods again
    for t in threads:
        t.join(600)
    for i, r in enumerate(results):
        if r is None or r["status"] != 200 or not r.get("done"):
            fail(f"profile wave: request {i} did not complete")
    steps = s2 - s1
    # the wrapper-counted launches and collectives per decode step, between
    # the first and the last dispatch marked in the window
    if len(marks) < 2:
        fail(f"profile wave: {len(marks)} decode dispatches marked in the window")
    (sa, na), (sb, nb) = marks[0], marks[-1]
    per_step = {k: (nb[k] - na[k]) / (sb - sa) for k in na}
    print(f"profile: per decode step in the window ({steps} steps): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_step.items()))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "decode_trace.json")
        prof.export_chrome_trace(path)
        kernels, dev = device_intervals_us(path)
        traced = trace_hook(path, dispatch_calls, gates) if trace_hook is not None else None
    gates = [e for e in dev if GATE_KERNEL in e["name"]]
    kernels = [e for e in kernels if GATE_KERNEL not in e["name"]]
    dev = [e for e in dev if GATE_KERNEL not in e["name"]]
    if not kernels or steps == 0:
        print(f"profile: device time not measured (the profiler recorded {len(kernels)} "
              f"kernels over {steps} decode steps)")
        return {"measured": False, "per_step": per_step, "window_epoch": (w0, w1),
                "trace": traced}
    busy, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + e["dur"], n + 1)
    dev_us = sum(e["dur"] for e in dev)
    shares = {w: sum(e["dur"] for e in kernels if any(k in e["name"] for k in names))
              / max(dev_us, 1e-9) for w, names in TRACE_KERNELS.items()}
    events = {k: sum(1 for e in kernels if k in e["name"])
              for names in TRACE_KERNELS.values() for k in names}
    if expert_calls:  # the int8 kernels' time split by wrapper (grid z)
        expert_us = sum(e["dur"] for e in kernels if expert_event(e))
        shares["int8_expert_matmul"] = expert_us / max(dev_us, 1e-9)
        shares["int8_weight_matmul"] -= shares["int8_expert_matmul"]
        events["expert events"] = sum(1 for e in kernels if expert_event(e))
    idle = max(0.0, 1.0 - busy / window_us)
    print(f"profile: {d2 - d1} decode dispatches, {steps} steps, {window_us / 1e3:.1f} ms "
          f"window (host clock); device busy {busy / 1e3:.2f} ms, idle share "
          f"{idle:.3f}; {len(kernels)} kernels = {len(kernels) / steps:.0f} per decode step, "
          f"{busy / steps / 1e3:.3f} ms device time per step")
    print("profile: share of device time " + ", ".join(f"{w} {v:.3f}" for w, v in shares.items())
          + "; device events " + ", ".join(f"{k} {n}" for k, n in events.items() if n)
          + f" over {calls} paged, {kv8_calls} int8-KV paged, {int8_calls} int8 and "
          f"{expert_calls} expert wrapper calls in the window "
          f"({events['paged_decode_split_kernel'] / max(calls, 1):.3f} split, "
          f"{events['paged_decode_int8_split_kernel'] / max(kv8_calls, 1):.3f} int8 split and "
          f"{events['paged_decode_merge_kernel'] / max(calls + kv8_calls, 1):.3f} merge events "
          f"per paged call)")
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  device {tot / 1e3:9.3f} ms  {n:6d} x  {tot / max(dev_us, 1e-9):6.3f}  "
              f"{name[:100]}")
    return {"measured": True, "steps": steps, "window_ms": window_us / 1e3,
            "device_busy_ms": busy / 1e3, "idle_share": idle,
            "paged_decode_share": shares["paged_decode_attention"],
            "paged_decode_int8_share": shares["paged_decode_attention_int8"],
            "int8_matmul_share": shares["int8_weight_matmul"],
            "expert_matmul_share": shares.get("int8_expert_matmul"),
            "device_ms_per_step": busy / steps / 1e3,
            "kernels_per_step": len(kernels) / steps, "wrapper_calls": calls,
            "window_epoch": (w0, w1), "gate_events": len(gates),
            "int8_kv_wrapper_calls": kv8_calls,
            "int8_wrapper_calls": int8_calls, "expert_wrapper_calls": expert_calls,
            "device_events": events, "per_step": per_step, "trace": traced}


@contextmanager
def http_server(chat, comp, name, flags):
    """``cli.run.run_http`` on a thread of its own; yields its port."""
    from dynamo_tpu_torch.cli.run import run_http

    loop = asyncio.new_event_loop()
    ready = threading.Event()
    task_box = []

    def serve():
        asyncio.set_event_loop(loop)
        task_box.append(loop.create_task(run_http(chat, comp, name, flags,
                                                  ready=lambda p: ready.set())))
        try:
            loop.run_until_complete(task_box[0])
        except asyncio.CancelledError:
            pass

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    if not ready.wait(60):
        fail("server did not start")
    try:
        yield flags.port
    finally:
        loop.call_soon_threadsafe(task_box[0].cancel)
        th.join(30)
        loop.close()


def request_bodies(name: str, n: int, max_tokens: int) -> list:
    """n streaming requests, chat and completions in turns, prompts of
    growing length."""
    words = ("the paged pool serves every lane of the batch while the decode window "
             "holds the newest keys and values ").split()
    bodies = []
    for i in range(n):
        text = " ".join(words[(i * 3 + j) % len(words)] for j in range(12 + 9 * i))
        common = {"model": name, "stream": True, "max_tokens": max_tokens,
                  "nvext": {"ignore_eos": True}, "stream_options": {"include_usage": True}}
        if i % 2 == 0:
            bodies.append(("/v1/chat/completions",
                           dict(common, messages=[{"role": "user", "content": text}])))
        else:
            bodies.append(("/v1/completions", dict(common, prompt=text)))
    return bodies


def run_streams(port: int, bodies: list, max_tokens: int, headers: list = None):
    """Send every request at once (request i with ``headers[i]``, when
    given); (results, send times, wall seconds). Fails unless each stream
    ends with a finish reason, [DONE] and ``max_tokens`` completion
    tokens."""
    results = [None] * len(bodies)
    t_sent = [0.0] * len(bodies)

    def run_one(i):
        results[i] = _stream(port, bodies[i][0], bodies[i][1], t_sent, i,
                             headers[i] if headers else None)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run_one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    for i, r in enumerate(results):
        if r is None:
            fail(f"request {i} did not complete")
        if r["status"] != 200:
            fail(f"request {i}: HTTP {r['status']} {r.get('error', '')[:300]}")
        if not r["finish"] or not r.get("done"):
            fail(f"request {i}: stream ended without finish_reason/[DONE]")
        if not r["usage"] or r["usage"]["completion_tokens"] != max_tokens:
            fail(f"request {i}: usage {r['usage']}, expected {max_tokens} completion tokens")
    return results, t_sent, wall


def wave_figures(results, t_sent, ttfts) -> tuple:
    """(TTFT p50 ms, decode tok/s) of one wave of N_REQUESTS streams of
    MAX_TOKENS: TTFT from engine enqueue to first token, tok/s over the
    lanes from the first token to the last stream's end."""
    first = min(t_sent) + min(ttfts)
    tok_s = N_REQUESTS * (MAX_TOKENS - 1) / (max(r["end"] for r in results) - first)
    return statistics.median(ttfts) * 1e3, tok_s


def reset_all_counts() -> None:
    from dynamo_tpu_torch.ops import int8_matmul, paged_attention
    from dynamo_tpu_torch.parallel import collectives

    paged_attention.reset_launch_counts()
    int8_matmul.reset_launch_counts()
    collectives.reset_counts()


def serve_and_count(card: str, label: str, core, chat, comp, name, flags) -> dict:
    """Answer N_REQUESTS concurrent streams through the HTTP pipeline with
    every launch count set to 0 just before and read just after, then
    profile a second wave."""
    from dynamo_tpu_torch.ops import int8_matmul
    from dynamo_tpu_torch.ops.int8_matmul import int8_expert_matmul, int8_weight_matmul
    from dynamo_tpu_torch.ops.paged_attention import (
        device_launches,
        paged_decode_attention,
        paged_decode_attention_sharded,
        splits_launched,
    )
    from dynamo_tpu_torch.parallel.collectives import all_gather, all_reduce

    with http_server(chat, comp, name, flags) as port:
        bodies = request_bodies(name, N_REQUESTS, MAX_TOKENS)
        reset_all_counts()
        steps0, chunks0 = core.decode_steps_total, core.chunk_dispatches
        results, t_sent, wall = run_streams(port, bodies, MAX_TOKENS)
        launches = paged_decode_attention.launches
        sharded_launches = paged_decode_attention_sharded.launches
        collective_calls = {"all_reduce": all_reduce.calls, "all_gather": all_gather.calls}
        kernel_launches = dict(device_launches)
        splits = dict(splits_launched)
        int8_launches = int8_weight_matmul.launches
        expert_launches = int8_expert_matmul.launches
        int8_kernels = {k: n for k, n in int8_matmul.device_launches.items() if n}
        steps = core.decode_steps_total - steps0
        chunks = core.chunk_dispatches - chunks0
        ttfts = list(core.recent_ttft_s)[-N_REQUESTS:]
        profile = profile_decode(port, bodies, core)
    L = core.model_config.num_layers
    print(f"{label}: {N_REQUESTS} streams (4 chat, 4 completions) HTTP 200, finish_reason "
          f"{sorted(set(r['finish'] for r in results))}, {MAX_TOKENS} completion tokens each")
    per_call = sum(kernel_launches.values()) / max(launches, 1)
    print(f"{label}: paged_decode_attention launches {launches} over {steps} decode steps "
          f"x {L} layers = {steps * L} ({launches / max(steps, 1):.0f} per step); device "
          f"launches " + ", ".join(f"{k} {n}" for k, n in kernel_launches.items())
          + f" ({per_call:.3f} per call); split counts launched {splits} (splits: calls); "
          f"int8_weight_matmul launches {int8_launches} "
          f"({int8_launches / max(steps, 1):.1f} per decode step), int8_expert_matmul "
          f"launches {expert_launches} (int8 device launches {int8_kernels}); {chunks} "
          f"prefill chunks")
    if steps == 0 or launches < L * steps:
        fail(f"paged_decode_attention ran {launches} times, expected >= {L} x {steps}")
    for k, n in kernel_launches.items():
        if n < L * steps:
            fail(f"{k} launched {n} times on the main path, expected >= {L} x {steps}")
    ttft_p50, decode_tok_s = wave_figures(results, t_sent, ttfts)
    print(f"{label}: TTFT p50 {ttft_p50:.1f} ms (engine enqueue -> first token), decode "
          f"{decode_tok_s:.1f} tok/s over {N_REQUESTS} lanes, wall {wall:.2f} s, on {card}")
    return {"launches": launches, "kernel_launches": kernel_launches,
            "device_launches_per_call": per_call, "splits": splits,
            "int8_launches": int8_launches, "int8_kernel_launches": int8_kernels,
            "expert_launches": expert_launches, "decode_steps": steps,
            "chunk_dispatches": chunks, "sharded_launches": sharded_launches,
            "collective_calls": collective_calls, "texts": [r["text"] for r in results],
            "ttft_p50_ms": ttft_p50, "decode_tok_s": decode_tok_s, "profile": profile}


# -- phase 6: load a checkpoint ---------------------------------------------------

LOAD_LAYERS = 2  # the checkpoint's depth: llama3-8b widths, ~3 GB of bf16


def write_safetensors(path: str, tensors: dict) -> int:
    """bf16 CPU tensors in the safetensors layout: a little-endian u64 header
    length, a JSON header (dtype, shape, data_offsets), the raw buffers.
    Returns the bytes written."""
    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 2
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.int16).numpy().data)
    return 8 + len(raw) + offset


def hf_checkpoint(torch, seed: int) -> dict:
    """Random bf16 weights on the card under the HF llama names, at
    llama3-8b widths and LOAD_LAYERS layers."""
    c = LLAMA3_8B
    E, F, V = c["hidden"], c["ffn"], c["vocab"]
    q, kv = c["heads"] * c["head_dim"], c["kv_heads"] * c["head_dim"]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") / shape[-1] ** 0.5).bfloat16()

    t = {"model.embed_tokens.weight": w(V, E)}
    for i in range(LOAD_LAYERS):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": 1 + w(E) * 4, p + "post_attention_layernorm.weight":
            1 + w(E) * 4, p + "self_attn.q_proj.weight": w(q, E),
            p + "self_attn.k_proj.weight": w(kv, E), p + "self_attn.v_proj.weight": w(kv, E),
            p + "self_attn.o_proj.weight": w(E, q), p + "mlp.gate_proj.weight": w(F, E),
            p + "mlp.up_proj.weight": w(F, E), p + "mlp.down_proj.weight": w(E, F),
        })
    t["model.norm.weight"] = 1 + w(E) * 4
    t["lm_head.weight"] = w(V, E)
    return t


def phase_load(card: str, path: str) -> dict:
    import torch

    from dynamo_tpu_torch.cli.run import build_engine, build_parser
    from dynamo_tpu_torch.engine_torch.weights import config_from_card, load_params
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    write_model_dir(path, num_layers=LOAD_LAYERS)
    tensors = hf_checkpoint(torch, 31)
    names = list(tensors)
    split = names.index("model.layers.1.input_layernorm.weight")
    t0 = time.perf_counter()
    nbytes = 0
    for i, part in enumerate((names[:split], names[split:])):
        nbytes += write_safetensors(os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"),
                                    {n: tensors[n].cpu() for n in part})
    write_s = time.perf_counter() - t0
    # the loader alone, timed: the files were just written, so this reads
    # the host's page cache, not the disk
    hf_card = ModelDeploymentCard.from_local_path(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = load_params(hf_card, config_from_card(hf_card), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del timed
    port = _free_port()
    flags = build_parser().parse_args(["--model-path", path, "--host", "127.0.0.1", "--port",
                                       str(port), "--max-batch-size", "2"])
    t0 = time.perf_counter()
    chat, comp, name, core = build_engine("torch", flags)
    build_s = time.perf_counter() - t0
    try:
        p, lp = core.params, core.params.layers
        pairs = [(p.embed, "model.embed_tokens.weight", False),
                 (p.final_norm, "model.norm.weight", False), (p.lm_head, "lm_head.weight", True)]
        hf = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
              "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
              "w_down": "mlp.down_proj"}
        for i in range(LOAD_LAYERS):
            pre = f"model.layers.{i}."
            pairs += [(lp["attn_norm"][i], pre + "input_layernorm.weight", False),
                      (lp["mlp_norm"][i], pre + "post_attention_layernorm.weight", False)]
            pairs += [(lp[k][i], f"{pre}{v}.weight", True) for k, v in hf.items()]
        if len(pairs) != len(tensors):
            fail(f"load: {len(pairs)} parameters checked, {len(tensors)} written")
        for got, hname, transpose in pairs:
            want = tensors[hname].T if transpose else tensors[hname]
            # matrices bf16 as written; norms fp32, which bf16 converts into exactly
            if got.shape != want.shape or not torch.equal(got, want.to(got.dtype)):
                fail(f"load: {hname} differs on the card from what was written")
        print(f"load: {len(pairs)} parameters bit-equal on the card to the {len(tensors)} "
              f"tensors written (llama3-8b widths, {LOAD_LAYERS} layers, bf16, 2 files)")
        with http_server(chat, comp, name, flags) as port:
            run_streams(port, request_bodies(name, 2, 8), 8)
        print("load: 2 streaming requests served over HTTP from the loaded checkpoint")
    finally:
        core.close()
    print(f"load: {nbytes / 1e9:.3f} GB written in {write_s:.2f} s; load_params to the card in "
          f"{load_s:.2f} s = {nbytes / load_s / 1e9:.2f} GB/s (files in the page cache); "
          f"build_engine (load, kernels, warmup) {build_s:.2f} s; on {card}")
    return {"gb": nbytes / 1e9, "load_s": load_s, "gb_s": nbytes / load_s / 1e9,
            "write_s": write_s, "build_engine_s": build_s}


# -- phase 7/8: serve bf16 --------------------------------------------------------

def phase_serve(card: str, model_dir: str) -> dict:
    from dynamo_tpu_torch.cli.run import build_engine, build_parser

    port = _free_port()
    flags = build_parser().parse_args([
        "--model-path", model_dir, "--host", "127.0.0.1", "--port", str(port),
        "--max-batch-size", str(N_REQUESTS),
    ])
    t0 = time.perf_counter()
    chat, comp, name, core = build_engine("torch", flags)
    print(f"serve: engine built and warmed up in {time.perf_counter() - t0:.1f} s "
          f"(llama3-8b width, bf16 random weights, {core.num_blocks} KV blocks)")
    served = serve_and_count(card, "serve", core, chat, comp, name, flags)
    served.update(core=core, flags=flags, name=name)
    return served


def _parity(label: str, a, b, limit: float = 2e-2) -> float:
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    rel = diff / max(scale, 1e-30)
    print(f"{label}: max|dlogits| {diff:.4e}, max|logits| {scale:.4e}, ratio {rel:.3e} "
          f"(limit {limit:g}), greedy agreement {agree:.3f}")
    if not rel <= limit:
        fail(label)
    return rel


def parity_case(torch, cfg, params, quantized: bool = False, last_chunk=None, mesh=None):
    """8 lanes of 100-500 prompt tokens prefilled into a fresh pool (int8
    pages with ``quantized``; per rank on ``mesh``, for sharded ``params``)
    with ``params`` (bf16 chunks), and the token at each lane's next
    position. ``last_chunk``, a list: the last prefill chunk's logits at its
    live positions are appended to it."""
    import numpy as np

    from dynamo_tpu_torch.models.llama import forward_chunk, make_kv_cache

    S, bs, per_lane = 8, 16, 32  # 32 pages = 512 tokens of room per lane
    rng = np.random.default_rng(7)
    lens = rng.integers(100, 500, size=S)
    cache = make_kv_cache(cfg, S * per_lane, bs, device="cuda", quantized=quantized, mesh=mesh)
    tables = torch.arange(S * per_lane, dtype=torch.int32, device="cuda").reshape(S, per_lane)
    tables = tables[:, torch.randperm(per_lane, generator=torch.Generator().manual_seed(1))]
    tables = tables.contiguous()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(S, 512))).cuda()
    with torch.no_grad():
        starts = list(range(0, int(lens.max()), 128))
        for c0 in starts:
            pos = torch.arange(c0, c0 + 128, device="cuda")[None, :].repeat(S, 1)
            pos = torch.where(pos < torch.from_numpy(lens).cuda()[:, None], pos, -1)
            keep = last_chunk is not None and c0 == starts[-1]
            out, _ = forward_chunk(params, cfg, toks[:, c0:c0 + 128], pos.int(), cache, tables,
                                   hidden_only=not keep, with_history=c0 > 0)
            if keep:  # what last_chunk_logits computes
                last_chunk.append(out[pos >= 0].float())
    base = torch.from_numpy(lens).cuda().int()
    nxt = toks[torch.arange(S), base.long()].int()  # the token at position base
    return cache, tables, base, nxt, toks, lens


def tp_case(torch, case, mesh):
    """``case`` (:func:`parity_case`) with its pool copied onto ``mesh``'s
    ranks: an unsharded pool split along its kv heads (global head order),
    a tp pool's ranks moved to the mesh's devices. The same bytes, so two
    forwards compared on the two cases start from one state."""
    cache, *rest = case
    if isinstance(cache, dict):
        w = cache["k"].shape[3] // mesh.tp
        pools = [{n: x[:, :, :, r * w:(r + 1) * w].to(d).contiguous() for n, x in cache.items()}
                 for r, d in enumerate(mesh.devices)]
    else:
        pools = [{n: x.to(d, copy=True) for n, x in pool.items()}
                 for pool, d in zip(cache, mesh.devices)]
    return (pools, *rest)


def last_chunk_logits(torch, cfg, params, case):
    """The last prefill chunk of :func:`parity_case` run again over the
    case's pool (its history masked below the chunk, untouched by the
    chunk's own writes), logits at its live positions."""
    from dynamo_tpu_torch.models.llama import forward_chunk

    cache, tables, _, _, toks, lens = case
    c0 = 128 * ((int(lens.max()) - 1) // 128)
    pos = torch.arange(c0, c0 + 128, device="cuda")[None, :].repeat(len(lens), 1)
    pos = torch.where(pos < torch.from_numpy(lens).cuda()[:, None], pos, -1)
    with torch.no_grad():
        out, _ = forward_chunk(params, cfg, toks[:, c0:c0 + 128], pos.int(), cache, tables,
                               with_history=c0 > 0)
    return out[pos >= 0].float()


def window_logits(torch, cfg, params, case, decode_attention):
    """One decode step's logits over the case's pool; ``decode_attention``
    None takes the default (the kernel; on a tp mesh the sharded one), and
    :class:`ShardedParams` get one window per rank on its device."""
    from dynamo_tpu_torch.models.llama import ShardedParams, forward_window

    cache, tables, base, nxt, _, _ = case
    if isinstance(params, ShardedParams):
        rc = params.shards[0].config
        shape = (cfg.num_layers, len(base), 1, rc.num_kv_heads, cfg.head_dim)
        wk = [torch.zeros(shape, dtype=cfg.dtype, device=d) for d in params.mesh.devices]
        wv = [torch.zeros(shape, dtype=cfg.dtype, device=d) for d in params.mesh.devices]
    else:
        shape = (cfg.num_layers, len(base), 1, cfg.num_kv_heads, cfg.head_dim)
        wk = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
        wv = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
    with torch.no_grad():
        logits, _, _ = forward_window(params, cfg, nxt, base, cache, tables, base, wk, wv, 0,
                                      decode_attention=decode_attention)
    torch.cuda.synchronize()
    return logits.float()


def phase_parity(core) -> float:
    import torch

    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    cfg = core.model_config
    case = parity_case(torch, cfg, core.params)
    outs = [window_logits(torch, cfg, core.params, case, fn)
            for fn in (paged_decode_attention, paged_decode_attention_plain)]
    lens = case[5]
    return _parity(f"decode parity (forward_window, llama3-8b width, 8 lanes, lengths "
                   f"{int(lens.min())}-{int(lens.max())})", outs[0], outs[1])


# -- phase 9/10: serve and check int8 -----------------------------------------------

def phase_int8_serve(card: str, served: dict) -> dict:
    """The bf16 engine's weights behind a quantize="int8" engine with the
    same configuration and the same HTTP pipeline; the bf16 engine is
    closed first."""
    import torch

    from dynamo_tpu_torch.cli.run import make_pipelines
    from dynamo_tpu_torch.engine_torch.engine import TorchServingEngine

    old = served.pop("core")
    old.close()
    params, cfg, ecfg = old.params, old.model_config, old.config
    del old
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    core = TorchServingEngine(cfg, params, dataclasses.replace(ecfg, quantize="int8"),
                              device="cuda")
    quant_s = time.perf_counter() - t0
    core.warmup()
    flags = served["flags"]
    flags.port = _free_port()
    chat, comp = make_pipelines(core_card(flags), core)
    print(f"int8 serve: weights quantized in {quant_s:.1f} s, engine warmed up in "
          f"{time.perf_counter() - t0:.1f} s (llama3-8b width, quantize=\"int8\": bf16 prefill, "
          f"int8 decode); {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated on the card")
    out = serve_and_count(card, "int8 serve", core, chat, comp, served["name"], flags)
    prof = [d["profile"] for d in (served, out)]
    print("int8 serve beside bf16 serve (same requests, same run): decode "
          f"{out['decode_tok_s']:.1f} vs {served['decode_tok_s']:.1f} tok/s, TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} vs {served['ttft_p50_ms']:.1f} ms"
          + ("; profiled decode step: device "
             f"{prof[1]['device_ms_per_step']:.3f} vs {prof[0]['device_ms_per_step']:.3f} ms, "
             f"idle share {prof[1]['idle_share']:.3f} vs {prof[0]['idle_share']:.3f}, "
             f"int8_weight_matmul {prof[1]['int8_matmul_share']:.3f} of device time"
             if all(p["measured"] for p in prof) else ""))
    want = INT8_LAUNCHES_PER_STEP * out["decode_steps"]
    if out["int8_launches"] != want or want == 0:
        fail(f"int8_weight_matmul launched {out['int8_launches']} times on the main path, "
             f"expected {INT8_LAUNCHES_PER_STEP} x {out['decode_steps']} decode steps = {want}")
    # decode runs 8 lanes: every product on the split-K kernel
    if out["int8_kernel_launches"] != {"w8a16_splitk_kernel": want}:
        fail(f"int8 decode device launches {out['int8_kernel_launches']}, expected "
             f"w8a16_splitk_kernel {want}")
    out["core"] = core
    return out


def core_card(flags):
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    return ModelDeploymentCard.from_local_path(flags.model_path, flags.model_name)


def int8_weight_matmul_plain64(x, q, s, *, out_dtype=None):
    """The plain version's function with the product summed in fp64: the
    correctly rounded product, up to one fp64 rounding. Beside the fp32
    plain version it measures how far two valid roundings of the same
    products drift apart through the model. Over 8192 output channels at a
    time: llama3-70b's LM head in fp64 whole (7.8 GiB) does not fit beside
    its int8 tree."""
    import torch

    out_dtype = out_dtype or x.dtype
    x64 = x.double()
    y = torch.cat([(x64 @ q[n:n + 8192].double().T).to(x.dtype)
                   for n in range(0, q.shape[0], 8192)], dim=-1)
    return (y.float() * s).to(out_dtype)


@contextmanager
def plain_int8(fn=None):
    """Route the model's int8 products through the plain version (or
    ``fn``)."""
    import dynamo_tpu_torch.models.llama as llama
    from dynamo_tpu_torch.ops.int8_matmul import int8_weight_matmul, int8_weight_matmul_plain

    llama.int8_weight_matmul = fn or int8_weight_matmul_plain
    try:
        yield
    finally:
        llama.int8_weight_matmul = int8_weight_matmul


def phase_int8_parity(core) -> dict:
    import torch

    from dynamo_tpu_torch.models.llama import forward_chunk, make_kv_cache
    from dynamo_tpu_torch.ops.int8_matmul import device_launches
    from dynamo_tpu_torch.ops.paged_attention import paged_decode_attention

    cfg, qp = core.model_config, core.params_decode
    case = parity_case(torch, cfg, core.params)
    kern = window_logits(torch, cfg, qp, case, paged_decode_attention)
    with plain_int8():
        plain = window_logits(torch, cfg, qp, case, paged_decode_attention)
    lens = case[5]
    window = _parity(f"int8 decode parity (forward_window of the int8 tree, kernel vs plain "
                     f"int8 products, llama3-8b width, 8 lanes, lengths "
                     f"{int(lens.min())}-{int(lens.max())})", kern, plain)
    del kern, plain
    # one "int8-all" prefill chunk: 8 lanes x 128 tokens from position 0
    toks = case[4][:, :128].contiguous()
    pos = torch.arange(128, device="cuda", dtype=torch.int32)[None, :].repeat(8, 1)
    tables = case[1]
    outs = []
    for ctx in (nullcontext(), plain_int8(), plain_int8(int8_weight_matmul_plain64)):
        cache = make_kv_cache(cfg, tables.numel(), 16, device="cuda")
        reset_all_counts()
        with torch.no_grad(), ctx:
            logits, _ = forward_chunk(qp, cfg, toks, pos, cache, tables, with_history=False)
        torch.cuda.synchronize()
        if not outs:  # the kernel's run: every product is a 1024-row one, on the tile kernel
            chunk_launches = dict(device_launches)
        outs.append(logits[:, -16:].float())
        del cache, logits
    print("int8-all chunk: int8 device launches "
          + ", ".join(f"{k} {n}" for k, n in chunk_launches.items())
          + f" ({INT8_LAUNCHES_PER_STEP} products of 1024 rows: 7 per layer and the LM head)")
    if {k: n for k, n in chunk_launches.items() if n} != {
            "w8a16_tile_kernel": INT8_LAUNCHES_PER_STEP}:
        fail(f"the int8-all chunk's products did not all run on the tile kernel: {chunk_launches}")
    chunk = _parity("int8-all chunk parity (forward_chunk of the int8 tree, 8 lanes x 128 "
                    "tokens, kernel vs plain int8 products; logits of the last 16 positions)",
                    outs[0], outs[1])
    floor = (outs[2] - outs[1]).abs().max().item() / outs[1].abs().max().item()
    print(f"int8-all chunk noise floor (not held): the plain products summed in fp64 against "
          f"the fp32 plain version through the same chunk: ratio {floor:.3e}; the kernel against "
          f"the fp64 plain version {(outs[0] - outs[2]).abs().max().item() / outs[2].abs().max().item():.3e}")
    return {"window_ratio": window, "chunk_ratio": chunk, "chunk_noise_floor": floor,
            "chunk_launches": chunk_launches}


# -- phase 11: int8 KV pages and the host tier ------------------------------------

def request_words(bodies: list, reverse: bool) -> list:
    """The bodies with each prompt's words in reverse order: the same lengths
    and no shared prefix block."""
    if not reverse:
        return bodies
    out = []
    for path, body in bodies:
        if "messages" in body:
            text = " ".join(reversed(body["messages"][0]["content"].split()))
            out.append((path, dict(body, messages=[{"role": "user", "content": text}])))
        else:
            out.append((path, dict(body, prompt=" ".join(reversed(body["prompt"].split())))))
    return out


def pool_blocks_for(bodies: list, bs: int, decode_steps: int) -> int:
    """An upper bound on the KV blocks one wave of ``bodies`` holds at once,
    the profiled wave's longer outputs included (byte-level prompts: a token
    per byte, plus the chat template)."""
    total = 0
    for _, body in bodies:
        text = body["messages"][0]["content"] if "messages" in body else body["prompt"]
        tokens = len(text.encode()) + 32 + max(MAX_TOKENS, PROFILE_TOKENS) + 2 * decode_steps
        total += -(-tokens // bs) + 1
    return total


def host_tier_probe(core) -> dict:
    """Wrap the engine's spill and inject: a device copy of each block as it
    is spilled (its first spill, which is what the host pool keeps), and
    after each injection the injected pages (and an int8 pool's scales)
    held bit for bit against that copy; on a tp engine the rank pools'
    pages in global head order (``core.pages``)."""
    import torch

    snap, stats = {}, {"spilled": 0, "injected": 0, "mismatched": 0}
    offload, inject = core._offload_blocks, core._inject_host_hits

    def spill(pairs):
        copies = core.pages([bid for _, bid, _ in pairs])
        for i, (h, _, _) in enumerate(pairs):
            snap.setdefault(h, {n: c[:, i] for n, c in copies.items()})
        stats["spilled"] += len(pairs)
        offload(pairs)

    def injected(alloc):
        hits = [(alloc.block_ids[h[0]], h[1]) for h in alloc.host_hits]
        inject(alloc)
        for bid, h in hits:
            now = core.pages([bid])
            same = set(now) == set(snap[h]) and all(
                torch.equal(x[:, 0], snap[h][n]) for n, x in now.items())
            stats["injected"] += 1
            stats["mismatched"] += not same

    core.allocator._offload = spill
    core._inject_host_hits = injected
    return stats


def phase_kv_int8_serve(card: str, int8_core, flags, name: str) -> dict:
    """The llama3-8b-width bf16 weights of phases 7 and 9 behind an engine
    with int8 KV pages and the host tier, the int8 engine closed first: 8
    concurrent streams, then 8 others that evict the first wave's cached
    blocks to host RAM, then the first wave's prompts again, which find
    them there. Checks 32 int8 paged launches per decode step and no bf16
    one, host hits, and every injected page and scale bit-equal to what was
    spilled; profiles decode; then one full-width int8-pool decode step
    through the kernel against its plain version (held at 2e-2), and its
    drift from the pool dequantized for the bf16 kernel and from a bf16
    pool (printed, not held)."""
    import torch

    from dynamo_tpu_torch.cli.run import make_pipelines
    from dynamo_tpu_torch.engine_torch.engine import TorchServingEngine
    from dynamo_tpu_torch.ops import paged_attention
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_int8,
        paged_decode_attention_int8_plain,
    )

    params, cfg, ecfg = int8_core.params, int8_core.model_config, int8_core.config
    del int8_core
    gc.collect()
    torch.cuda.empty_cache()
    weights = {"params": params, "cfg": cfg, "ecfg": ecfg}
    bodies = request_bodies(name, N_REQUESTS, MAX_TOKENS)
    evicting = request_words(bodies, reverse=True)
    blocks = pool_blocks_for(bodies, ecfg.kv_block_size, ecfg.decode_steps) + 16
    t0 = time.perf_counter()
    core = TorchServingEngine(cfg, params, dataclasses.replace(
        ecfg, quantize=None, kv_dtype="int8", num_kv_blocks=blocks,
        host_cache_blocks=4 * blocks), device="cuda")
    core.warmup()
    flags.port = _free_port()
    chat, comp = make_pipelines(core_card(flags), core)
    L = cfg.num_layers
    print(f"kv int8 serve: engine warmed up in {time.perf_counter() - t0:.1f} s (llama3-8b "
          f"width, bf16 weights, int8 KV pages, {blocks} KV blocks = "
          f"{sum(x.numel() * x.element_size() for x in core.cache.values()) / 1e9:.3f} GB, "
          f"host tier of {4 * blocks} blocks)")
    probe = host_tier_probe(core)
    with http_server(chat, comp, name, flags) as port:
        reset_all_counts()
        steps0 = core.decode_steps_total
        waves = []
        for label, wave in (("first", bodies), ("evicting", evicting), ("repeat", bodies)):
            results, t_sent, wall = run_streams(port, wave, MAX_TOKENS)
            waves.append(results)
            m = core.metrics_snapshot()
            print(f"kv int8 serve: {label} wave, {len(wave)} streams HTTP 200, {MAX_TOKENS} "
                  f"tokens each, wall {wall:.2f} s; host tier {m['host_cache_blocks']} blocks, "
                  f"{m['host_cache_hits']} hits; prefix hit rate "
                  f"{m['gpu_prefix_cache_hit_rate']:.3f}; preemptions {m['preemptions']}")
            if label == "evicting":  # the spills reach the host pool between waves
                deadline = time.perf_counter() + 30
                while not len(core.host_pool) and time.perf_counter() < deadline:
                    time.sleep(0.01)
        launches = paged_decode_attention_int8.launches
        kernels = dict(paged_attention.int8_device_launches)
        bf16_launches = paged_decode_attention.launches
        bf16_kernels = dict(paged_attention.device_launches)
        steps = core.decode_steps_total - steps0
        ttfts = list(core.recent_ttft_s)[-N_REQUESTS:]
        metrics = core.metrics_snapshot()
        profile = profile_decode(port, bodies, core)
    same_text = sum(a["text"] == b["text"] for a, b in zip(waves[0], waves[2]))
    print(f"kv int8 serve: paged_decode_attention_int8 launches {launches} over {steps} decode "
          f"steps x {L} layers = {steps * L} ({launches / max(steps, 1):.0f} per step); device "
          f"launches " + ", ".join(f"{k} {n}" for k, n in kernels.items())
          + f"; bf16 paged_decode_attention launches {bf16_launches} ({bf16_kernels}); "
          f"host tier: {probe['spilled']} blocks spilled, {metrics['host_cache_hits']} hits, "
          f"{probe['injected']} pages injected, {probe['mismatched']} not bit-equal to their "
          f"spill (k, v, k_scale, v_scale); repeat wave texts equal to the first wave's: "
          f"{same_text} of {N_REQUESTS} (not held)")
    if steps == 0 or launches != L * steps:
        fail(f"paged_decode_attention_int8 ran {launches} times, expected {L} x {steps}")
    if any(n != L * steps for n in kernels.values()):
        fail(f"int8 paged device launches {kernels}, expected {L * steps} each")
    if bf16_launches or any(bf16_kernels.values()):
        fail(f"the bf16 paged kernel ran on an int8 pool: {bf16_launches}, {bf16_kernels}")
    if metrics["host_cache_hits"] <= 0 or probe["injected"] <= 0:
        fail(f"the host tier served no hit: {metrics['host_cache_hits']} hits, "
             f"{probe['injected']} injected")
    if probe["mismatched"]:
        fail(f"{probe['mismatched']} injected pages differ from what was spilled")
    core.close()
    del core
    gc.collect()
    torch.cuda.empty_cache()
    # one full-width decode step over an int8 pool, kernel against plain
    case8 = parity_case(torch, cfg, params, quantized=True)
    kern = window_logits(torch, cfg, params, case8, paged_decode_attention_int8)
    plain = window_logits(torch, cfg, params, case8, paged_decode_attention_int8_plain)
    lens = case8[5]
    ratio = _parity(f"int8-KV decode parity (forward_window over an int8 pool, kernel vs plain, "
                    f"llama3-8b width, 8 lanes, lengths {int(lens.min())}-{int(lens.max())})",
                    kern, plain)
    deq = window_logits(torch, cfg, params, case8, functools.partial(dequant_then_bf16, torch))
    deq_drift = (kern - deq).abs().max().item() / deq.abs().max().item()
    print(f"int8-KV pool through the kernel against the same pool dequantized for the bf16 "
          f"kernel (dequantize_kv, then paged_decode_attention; not held): max|dlogits| / "
          f"max|logits| {deq_drift:.3e}, greedy agreement "
          f"{(kern.argmax(-1) == deq.argmax(-1)).float().mean().item():.3f}")
    del case8, plain, deq
    case = parity_case(torch, cfg, params)
    bf16_pool = window_logits(torch, cfg, params, case, paged_decode_attention)
    drift = (kern - bf16_pool).abs().max().item() / bf16_pool.abs().max().item()
    agree = (kern.argmax(-1) == bf16_pool.argmax(-1)).float().mean().item()
    print(f"int8-KV pool against a bf16 pool (not held): the same 8 prompts and step, "
          f"max|dlogits| / max|logits| {drift:.3e}, greedy agreement {agree:.3f}")
    del case, kern, bf16_pool
    torch.cuda.empty_cache()
    first = min(t_sent) + min(ttfts)
    return {"launches": launches, "device_launches": kernels, "bf16_launches": bf16_launches,
            "decode_steps": steps, "host_cache_hits": metrics["host_cache_hits"],
            "host_cache_blocks": metrics["host_cache_blocks"], "spilled": probe["spilled"],
            "injected": probe["injected"], "injected_mismatched": probe["mismatched"],
            "repeat_texts_equal": same_text, "kv_blocks": blocks,
            "ttft_p50_ms": statistics.median(ttfts) * 1e3,
            "decode_tok_s_last_wave": N_REQUESTS * (MAX_TOKENS - 1)
            / (max(r["end"] for r in waves[2]) - first),
            "profile": profile, "parity_ratio": ratio, "dequantized_pool_drift": deq_drift,
            "bf16_pool_drift": drift,
            "bf16_pool_greedy_agreement": agree, "weights": weights}


# -- phases 12-13: the integrity plane and speculative decoding -------------------

SPEC_TOKENS = 64  # the speculative serve's output per stream


def token_prompts(rng, lengths, vocab: int) -> list:
    return [rng.integers(0, vocab, size=int(n)).tolist() for n in lengths]


def engine_wave(core, prompts: list, max_tokens: int) -> dict:
    """Every prompt at once straight into ``core.generate`` (the engine's
    own entry point, no HTTP), greedy, ``max_tokens`` each with EOS
    ignored. Per stream: tokens, the ``migrating`` marker or None, the
    finish reason; the engine's TTFT p50 (enqueue -> first token) and the
    decode tok/s of the wave (tokens after each stream's first, over the
    span from the first first token to the last stream's end)."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(prompt):
        req = PreprocessedRequest(
            token_ids=list(prompt),
            stop_conditions=StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=SamplingOptions(temperature=0.0))
        toks, marker, finish, first = [], None, None, None
        async for item in core.generate(Context(req)):
            if item.is_error:
                fail(f"engine error: {item.error_message()}")
            d = item.data or {}
            if "migrating" in d:
                marker = d["migrating"]
                continue
            if d.get("token_ids") and first is None:
                first = time.perf_counter()
            toks.extend(d.get("token_ids", []))
            finish = d.get("finish_reason") or finish
        return toks, marker, finish, first, time.perf_counter()

    async def wave():
        return await asyncio.gather(*[one(p) for p in prompts])

    n0 = len(core.recent_ttft_s)
    out = asyncio.run(wave())
    ttfts = list(core.recent_ttft_s)[n0:]
    firsts = [r[3] for r in out if r[3] is not None]
    span = max(r[4] for r in out) - min(firsts) if firsts else 0.0
    decoded = sum(max(len(r[0]) - 1, 0) for r in out)
    return {"tokens": [r[0] for r in out], "markers": [r[1] for r in out],
            "finish": [r[2] for r in out],
            "ttft_p50_ms": statistics.median(ttfts) * 1e3 if ttfts else None,
            "decode_tok_s": decoded / span if span > 0 else None}


def fresh_engine(params, cfg, ecfg, **changes):
    from dynamo_tpu_torch.engine_torch.engine import TorchServingEngine

    core = TorchServingEngine(cfg, params, dataclasses.replace(ecfg, **changes), device="cuda")
    core.warmup()
    return core


def close_engine(core) -> None:
    import torch

    core.close()
    gc.collect()
    torch.cuda.empty_cache()


@contextmanager
def integrity_env(on: bool):
    """``DYN_TPU_KV_INTEGRITY`` as the engine's construction reads it:
    unset (the default, on) or 0."""
    old = os.environ.pop("DYN_TPU_KV_INTEGRITY", None)
    if not on:
        os.environ["DYN_TPU_KV_INTEGRITY"] = "0"
    try:
        yield
    finally:
        os.environ.pop("DYN_TPU_KV_INTEGRITY", None)
        if old is not None:
            os.environ["DYN_TPU_KV_INTEGRITY"] = old


def first_difference(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def three_waves(core, prompts, evicting, rule=None, seed=0) -> dict:
    """Phase 11's layout at engine level: the prompts, then as many others
    that evict their cached blocks to the host tier, then the prompts
    again; with ``rule``, a fault injector holding it (seeded with ``seed``)
    is active throughout. Returns the first and third waves' tokens, each
    spill's size and first block's hash, the host hits of the third wave,
    the kv trips counted, and the host-tier entries whose bytes no longer
    hash to their seal checksum before the third wave (the corrupted
    ones), by the prompt whose chain holds them."""
    from dynamo_tpu_torch.engine_torch.allocator import resolve_crc
    from dynamo_tpu_torch.kv.tokens import compute_block_hashes_for_seq
    from dynamo_tpu_torch.runtime import faults, integrity

    spills, offload = [], core.allocator._offload

    def spill(pairs):
        spills.append((len(pairs), pairs[0][0]))
        offload(pairs)

    core.allocator._offload = spill
    trips0 = integrity.counters()["kv_integrity_failures_total"]
    inj = faults.FaultInjector([rule] if rule is not None else [], seed=seed)
    with faults.active(inj):
        first = engine_wave(core, prompts, MAX_TOKENS)
        engine_wave(core, evicting, MAX_TOKENS)
        deadline = time.perf_counter() + 30  # the idle engine harvests its spills
        while core._pending_spills and time.perf_counter() < deadline:
            time.sleep(0.01)
        bad = [h for h, e in list(core.host_pool._data.items())
               if e[4] is not None and integrity.entry_checksum(*e[:4]) != resolve_crc(e[4])]
        hits0 = core.host_pool.hits
        third = engine_wave(core, prompts, MAX_TOKENS)
    chains = [compute_block_hashes_for_seq(p, core.config.kv_block_size) for p in prompts]
    return {"first": first["tokens"], "third": third["tokens"], "spills": spills,
            "chains": chains, "corrupted_blocks": [
                (i, c.index(h)) for h in bad for i, c in enumerate(chains) if h in c],
            "host_hits": core.host_pool.hits - hits0, "spilled": core.host_pool.offloaded,
            "kv_trips": integrity.counters()["kv_integrity_failures_total"] - trips0,
            "corrupted": len(bad),
            "fault_log": [(d.op_index, d.detail) for d in inj.log]}


def phase_integrity(card: str, weights: dict) -> dict:
    """The integrity plane at llama3-8b width and full depth, random bf16
    weights, 8 lanes of 100-500 random prompt tokens: (a) a ``poison`` rule
    on one decode dispatch; (b) integrity off against the default (TTFT,
    decode tok/s, the checksums' seconds); (c) a ``corrupt`` rule on one
    host-tier spill in phase 11's three-wave layout (int8 KV pages, a pool
    that holds one wave, a host tier of 4x the pool). Each run is a fresh
    engine over the same weights."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.runtime import faults, integrity

    params, cfg, ecfg = weights["params"], weights["cfg"], weights["ecfg"]
    rng = np.random.default_rng(12)
    lens = [int(n) for n in rng.integers(100, 500, size=N_REQUESTS)]
    prompts = token_prompts(rng, lens, cfg.vocab_size)
    evicting = token_prompts(rng, lens, cfg.vocab_size)
    ds = ecfg.decode_steps

    # (a) the default engine, then a poisoned third decode dispatch
    runs = {}
    for label, on in [(f"{'on' if on else 'off'} {i}", on) for i in range(3) for on in (1, 0)]:
        with integrity_env(on):
            core = fresh_engine(params, cfg, ecfg)
        if (core._integrity is not None) != on:
            fail(f"integrity {label}: the engine's plane is {core._integrity}")
        wave = engine_wave(core, prompts, MAX_TOKENS)
        wave.update(chunks=core.chunk_dispatches, crc_s=core.crc_seconds,
                    crc_blocks=core.crc_blocks, crc_flush_s=core.crc_flush_seconds,
                    trips=core.watchdog_trips)
        runs[label] = wave
        close_engine(core)
    clean = runs["on 0"]
    if any(f != "length" or len(t) != MAX_TOKENS for f, t in zip(clean["finish"], clean["tokens"])):
        fail("integrity: the clean wave did not finish every stream at max_tokens")
    D = clean["chunks"] + 2  # the third decode dispatch: two decode dispatches before it
    core = fresh_engine(params, cfg, ecfg)
    core._fault_addr = "chip-smoke"
    rule = faults.FaultRule(plane="engine", point="dispatch", action="poison",
                            match_addr="chip-smoke", after_ops=2 * D, max_fires=1)
    inj = faults.FaultInjector([rule])
    # each lane's tokens from the dispatches before the poisoned one: those
    # emitted when it is made, plus the in-flight dispatch's
    before, all_decoding, wd_args = {}, [], core._wd_args

    def watched():
        n = len(inj.log)
        args = wd_args()
        if len(inj.log) > n:
            ahead = core._inflight
            for i, seq in enumerate(core._slots):
                if seq is not None:
                    inflight = ahead is not None and ahead.lanes[i] is seq
                    before[prompts.index(seq.prompt)] = seq.emitted + (ds if inflight else 0)
            all_decoding.append(all(s is not None and s.prefill_pos is None
                                    for s in core._slots))
        return args

    core._wd_args = watched
    trips0 = integrity.counters()["watchdog_trips_total"]
    with faults.active(inj):
        pois = engine_wave(core, prompts, MAX_TOKENS)
    wd_trips, wd_counted = core.watchdog_trips, integrity.counters()["watchdog_trips_total"] - trips0
    close_engine(core)
    marker = {"resume": True, "error": "output watchdog: non-finite or exploding logits"}
    counts = [len(t) for t in pois["tokens"]]
    exact = [len(t) == before.get(i) and t == c[:len(t)]
             for i, (t, c) in enumerate(zip(pois["tokens"], clean["tokens"]))]
    held = (all(m == marker for m in pois["markers"]) and not any(pois["finish"])
            and all(exact) and all_decoding == [True] and wd_trips == N_REQUESTS == wd_counted)
    print(f"integrity poison drill: dispatch {D} poisoned ({clean['chunks']} prefill chunks, "
          f"then decode dispatches of {ds} steps; every lane decoding: {all_decoding}): every "
          f"lane ended with the watchdog's resume directive: "
          f"{all(m == marker for m in pois['markers'])}, finish reasons "
          f"{sorted(set(map(str, pois['finish'])))}, tokens per lane {counts} (those of the "
          f"dispatches before the poisoned one: {[before.get(i) for i in range(N_REQUESTS)]}), "
          f"each equal to the clean run's first ones: {all(exact)}; watchdog trips {wd_trips} "
          f"(engine), {wd_counted} (tracker)")
    if not held:
        fail("integrity poison drill")
    same = sum(a == b for a, b in zip(runs["off 0"]["tokens"], clean["tokens"]))
    block_bytes = sum(x.numel() * x.element_size() for x in (
        torch.empty((cfg.num_layers, ecfg.kv_block_size, cfg.num_kv_heads, cfg.head_dim),
                    dtype=cfg.dtype),) * 2)
    for label, r in runs.items():
        print(f"integrity {label}: TTFT p50 {r['ttft_p50_ms']:.1f} ms, decode "
              f"{r['decode_tok_s']:.1f} tok/s over {N_REQUESTS} lanes; seal checksums "
              f"{r['crc_blocks']} blocks ({r['crc_blocks'] * block_bytes / 2**20:.0f} MiB) in "
              f"{r['crc_s']:.3f} s of the crc thread, {r['crc_flush_s'] * 1e3:.1f} ms of the "
              f"engine thread starting them, on {card}")
    # the pinned copy's rate: the stream time the checksums' copies take
    src = torch.empty(64 * block_bytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(5):
        dst.copy_(src, non_blocking=True)
    t1.record()
    t1.synchronize()
    d2h = 5 * src.numel() / (t0.elapsed_time(t1) * 1e-3)
    del src, dst
    on = [r for lab, r in runs.items() if lab.startswith("on")]
    off = [r for lab, r in runs.items() if lab.startswith("off")]
    ttft_on = statistics.median(r["ttft_p50_ms"] for r in on)
    ttft_off = statistics.median(r["ttft_p50_ms"] for r in off)
    print(f"integrity on against off (medians of 3 alternating runs each): TTFT p50 "
          f"{ttft_on:.1f} vs {ttft_off:.1f} ms, decode "
          f"{statistics.median(r['decode_tok_s'] for r in on):.1f} vs "
          f"{statistics.median(r['decode_tok_s'] for r in off):.1f} tok/s; the checksums' "
          f"pinned copies {on[0]['crc_blocks'] * block_bytes / d2h * 1e3:.1f} ms of stream time "
          f"per wave at {d2h / 1e9:.1f} GB/s (device to pinned host, measured); streams with "
          f"integrity off equal to the default's: {same} of {N_REQUESTS} (not held)")

    # (c) the corrupt drill on the three-wave layout, with prompts of one
    # prefill chunk each. The clean run first: its spills are the corrupt
    # run's (the allocator is deterministic), so the injector's seed is
    # chosen, by running the injector on zeros of the first spill's shape,
    # to put the flipped byte in the first spill's first block, the
    # block 0 of the prompt whose blocks the LRU evicts first. The prefix
    # miss there recomputes that prompt from position 0 in one chunk, as the
    # first wave computed it, and every lane's dispatches stay those of the
    # clean run
    lens = [int(n) for n in rng.integers(100, ecfg.prefill_chunk + 1, size=N_REQUESTS)]
    prompts = token_prompts(rng, lens, cfg.vocab_size)
    evicting = token_prompts(rng, lens, cfg.vocab_size)
    blocks = sum(-(-(n + MAX_TOKENS + 2 * ds) // ecfg.kv_block_size) + 1 for n in lens) + 16
    layout = dict(kv_dtype="int8", num_kv_blocks=blocks, host_cache_blocks=4 * blocks)
    core = fresh_engine(params, cfg, ecfg, **layout)
    c = three_waves(core, prompts, evicting)
    close_engine(core)
    n0, h0 = c["spills"][0]
    (target,) = [(i, ch.index(h0)) for i, ch in enumerate(c["chains"]) if h0 in ch] or [None]

    def corrupt_rule():
        return faults.FaultRule(plane="engine", point="pages", action="corrupt", max_fires=1)

    def flipped_block(seed):
        """The block of the first spill (k pages [L, n0, bs, KVH, D]) whose
        byte ``corrupt_array`` flips under an injector seeded with
        ``seed``, found by running it on zeros of that shape."""
        zeros = torch.zeros((cfg.num_layers, n0, ecfg.kv_block_size * cfg.num_kv_heads
                             * cfg.head_dim), dtype=torch.int8)
        with faults.active(faults.FaultInjector([corrupt_rule()], seed=seed)):
            out = faults.corrupt_array("engine", "engine", zeros)
        return int(out.nonzero()[0, 1])

    seed = next(s_ for s_ in range(100000) if flipped_block(s_) == 0)
    core = fresh_engine(params, cfg, ecfg, **layout)
    k = three_waves(core, prompts, evicting, corrupt_rule(), seed=seed)
    close_engine(core)
    # the target lane recomputes its prompt as the first wave computed it, so
    # its third wave equals its first wave's; every other lane's third wave
    # is computed as in the clean run and equals the clean third wave. The
    # target against the clean third wave is printed: there the lane
    # attends its cached bytes plus a tail computed against them, which
    # rounds otherwise in bf16 (as other lanes' third waves differ from
    # their first waves in both runs)
    tgt = target[0] if target is not None else -1
    equal = sum(a == b for i, (a, b) in enumerate(zip(c["third"], k["third"])) if i != tgt)
    replayed = tgt >= 0 and k["third"][tgt] == k["first"][tgt] == c["first"][tgt]
    lanes = [(int(a == b), int(a == f), int(b == g), first_difference(a, b))
             for a, b, f, g in zip(k["third"], c["third"], k["first"], c["first"])]
    print(f"integrity corrupt drill, per lane (corrupt third == clean third, corrupt third == "
          f"its first, clean third == its first, first difference): {lanes}")
    print(f"integrity corrupt drill (int8 KV pool of {blocks} blocks, host tier "
          f"{4 * blocks}, prompts of {min(lens)}-{max(lens)} tokens; the first spill: {n0} "
          f"blocks, the first (prompt, block) {target}; seed {seed}): clean: "
          f"{len(c['spills'])} spills, third wave {c['host_hits']} host hits, {c['kv_trips']} kv "
          f"trips; corrupt: fault log {k['fault_log']}, host entries failing their checksum "
          f"(prompt, block) {k['corrupted_blocks']}, third wave {k['host_hits']} host hits, "
          f"{k['kv_trips']} kv trips; third-wave tokens of the other lanes equal to the clean "
          f"third wave's: {equal} of {N_REQUESTS - 1}; the recomputed lane's equal to its first "
          f"wave's: {replayed}, to the clean third wave's: "
          f"{tgt >= 0 and k['third'][tgt] == c['third'][tgt]} (not held); first waves equal: "
          f"{c['first'] == k['first']}")
    if (c["kv_trips"] or c["corrupted"] or c["host_hits"] <= 0 or k["kv_trips"] != 1
            or target is None or target[1] != 0 or k["corrupted_blocks"] != [target]
            or k["host_hits"] >= c["host_hits"] or c["first"] != k["first"]
            or equal != N_REQUESTS - 1 or not replayed):
        fail("integrity corrupt drill")
    drill = lambda d: {f: d[f] for f in ("host_hits", "kv_trips", "corrupted_blocks",  # noqa: E731
                                         "fault_log")}
    return {"poisoned_dispatch": D, "tokens_before_poison": counts, "watchdog_trips": wd_trips,
            "runs": {k_: {f: r[f] for f in ("ttft_p50_ms", "decode_tok_s", "crc_s", "crc_blocks",
                                            "crc_flush_s")} for k_, r in runs.items()},
            "ttft_p50_ms_on_off": [ttft_on, ttft_off], "d2h_gb_s": d2h / 1e9,
            "off_streams_equal": same, "corrupt_drill": {
                "clean": drill(c), "corrupt": drill(k), "seed": seed, "first_spill": n0,
                "target": target,
                "spills": len(c["spills"]), "third_wave_equal_other_lanes": equal,
                "recomputed_lane_replays_first_wave": replayed,
                "recomputed_lane_equal_clean_third": k["third"][tgt] == c["third"][tgt],
                "lanes": lanes, "pool_blocks": blocks}}


def repeating_prompts(rng, vocab: int) -> list:
    """8 prompts that repeat a phrase: a random lead, then a phrase of 6-13
    random tokens repeated to 100-300 tokens."""
    out = []
    for i in range(N_REQUESTS):
        phrase = rng.integers(0, vocab, size=6 + i).tolist()
        n = int(rng.integers(100, 300))
        body = (phrase * (n // len(phrase) + 1))[:n]
        out.append(rng.integers(0, vocab, size=8).tolist() + body)
    return out


def profile_call(fn) -> dict:
    """torch.profiler (CUDA) over one call of ``fn`` on an idle card: device
    busy ms (the union of device events), kernels, and the call's wall ms;
    "not measured" when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        kernels, dev = device_intervals_us(path)
    if not kernels:
        return {"measured": False, "wall_ms": wall}
    busy, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"measured": True, "device_ms": busy / 1e3, "kernels": len(kernels), "wall_ms": wall,
            "top": [(name[:90], us / 1e3) for name, us in top]}


def dispatch_inputs(core, lens, k1):
    """Engine-shaped inputs of one verify dispatch (tokens/positions [S, k1])
    and of one decode dispatch (tokens/positions [S]) over lanes of the given
    lengths, with tables as wide as the engine's (max_model_len)."""
    import numpy as np

    S, MB = core.config.max_slots, core.config.max_blocks_per_seq
    rng = np.random.default_rng(13)
    tables = rng.permutation(core.num_blocks)[: S * MB].reshape(S, MB).astype(np.int32)
    toks = rng.integers(0, core.model_config.vocab_size, size=(S, k1)).astype(np.int32)
    pos = (np.asarray(lens)[:, None] + np.arange(k1)[None, :]).astype(np.int32)
    return core._put(toks), core._put(pos), core._put(tables)


def profile_dispatches(core, lens, k1) -> tuple:
    """One verify and one decode dispatch on the idle engine over lanes of
    the given lengths, each profiled (:func:`profile_call`); the launches
    they make are not the main path's. Returns (verify, decode) profiles."""
    import numpy as np

    vt, vp, tables = dispatch_inputs(core, lens, k1)
    zero = core._put(np.zeros((N_REQUESTS,), np.int32))
    samp = core._sampling_args()
    wd = core._wd_args()
    verify = core._verify(False, False, False)
    decode = core._decode(False, False, False)
    with core._device_scope():
        verify(vt, vp, tables, 1, *samp, core._dummy_counts(), *wd)  # warm
        vprof = profile_call(lambda: verify(vt, vp, tables, 1, *samp, core._dummy_counts(), *wd))
        dprof = profile_call(lambda: decode(zero, vp[:, 0].contiguous(), tables, 1, *samp,
                                            core._dummy_counts(), *wd))
    return vprof, dprof


def chunk_logits(torch, cfg, params, case, k1):
    """The verify dispatch's forward on a parity case: [next token, k1 - 1
    following tokens] per lane through ``forward_chunk`` and the LM head on
    every position, [S, k1, V] fp32. Writes those positions' K/V into the
    pool, above what any parity read attends."""
    from dynamo_tpu_torch.models.llama import forward_chunk, lm_head

    cache, tables, base, _, toks, _ = case
    S = len(base)
    rows = base[:, None].long() + torch.arange(k1, device="cuda")[None, :]
    fed = torch.gather(toks, 1, rows).int()
    with torch.no_grad():
        h, _ = forward_chunk(params, cfg, fed, rows.int(), cache, tables, hidden_only=True)
        out = lm_head(params, cfg, h.reshape(S * k1, -1)).reshape(S, k1, -1).float()
    torch.cuda.synchronize()
    return out


def verify_logits(torch, cfg, params, case, k1):
    """:func:`chunk_logits`, and the same positions decoded one step at a
    time through ``forward_window`` (the paged kernel). Returns both
    [S, k1, V]."""
    from dynamo_tpu_torch.models.llama import forward_window

    cache, tables, base, _, toks, _ = case
    S = len(base)
    rows = base[:, None].long() + torch.arange(k1, device="cuda")[None, :]
    fed = torch.gather(toks, 1, rows).int()
    shape = (cfg.num_layers, S, k1, cfg.num_kv_heads, cfg.head_dim)
    wk = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
    wv = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
    with torch.no_grad():
        seq = []
        for j in range(k1):  # reads the pool below base only: the verify writes come after
            logits, wk, wv = forward_window(params, cfg, fed[:, j], base + j, cache, tables,
                                            base, wk, wv, j)
            seq.append(logits.float())
    torch.cuda.synchronize()
    return chunk_logits(torch, cfg, params, case, k1), torch.stack(seq, 1)


def fp32_tree(torch, cfg, params):
    """The fp32 tree of the model function that ``params`` (bf16 or int8
    weights) computes: each matrix upcast, or dequantized as ``q * s``, in
    the ``[in, out]`` layout; norms upcast. Built one layer at a time on
    the card (32 GB at llama3-8b width)."""
    from dynamo_tpu_torch.models.llama import Int8Weight, LlamaParams

    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    out = LlamaParams(c32, torch.device("cuda"))

    def f32(w, per_row=False):
        if not isinstance(w, Int8Weight):
            return w.float()
        deq = w.q.float() * w.s[:, None]
        return deq if per_row else deq.T  # [out, in] -> [in, out]

    with torch.no_grad():
        out.final_norm.copy_(params.final_norm)
        out.embed.copy_(f32(params.weight("embed"), per_row=True))
        if not cfg.tie_embeddings:
            out.lm_head.copy_(f32(params.weight("lm_head")))
        for i in range(cfg.num_layers):
            for k, w in params.layer(i).items():
                out.layers[k][i].copy_(f32(w))
    return c32, out


def verify_parity(torch, cfg, params, k1) -> dict:
    """The verify forward (``forward_chunk`` over k1 positions, the LM head
    on each) against the same positions decoded one step at a time
    (``forward_window``, the paged kernel), at full width and depth, bf16
    weights and then their int8 tree. Held at 2e-2: verify against
    sequential, bf16 and int8 (the verify dispatch's M = 8 x k1 products
    are planned onto the split-K kernel, the one-step path's kernel); int8
    verify through the W8A16 kernels against the same forward through the
    int8 products' plain version; each path, bf16 and int8, against the fp32
    evaluation of the same weights (the model function without bf16
    rounding). Printed beside them: int8 verify against sequential with
    both through the plain products."""
    from dynamo_tpu_torch.models.llama import quantize_params_int8

    case = parity_case(torch, cfg, params)
    lens = case[5]
    where = (f"llama3-8b width, 8 lanes x {k1} positions, lengths "
             f"{int(lens.min())}-{int(lens.max())}")
    out = {}
    for label in ("bf16", "int8"):
        p = params if label == "bf16" else quantize_params_int8(params, cfg)
        ver, seq = verify_logits(torch, cfg, p, case, k1)
        name = f"verify parity [{label} weights] (forward_chunk vs forward_window one step at a time, {where})"
        out[label] = _parity(name, ver, seq)
        scale = seq.abs().max().item()
        per_pos = [((ver[:, j] - seq[:, j]).abs().max().item() / scale) for j in range(k1)]
        print(f"  per position (max|dlogits| / max|logits|): "
              + ", ".join(f"{r:.3e}" for r in per_pos))
        out[label + "_per_position"] = per_pos
        if label == "int8":
            with plain_int8():
                ver_p, seq_p = verify_logits(torch, cfg, p, case, k1)
            out["int8_kernel_vs_plain"] = _parity(
                f"verify parity [int8 weights] (forward_chunk through the W8A16 kernels vs "
                f"through their plain version, M = {len(lens) * k1}, {where})", ver, ver_p)
            out["int8_plain"] = _parity(
                f"verify parity [int8 weights, plain products] (forward_chunk vs forward_window "
                f"one step at a time, both through the int8 products' plain version, {where}) "
                f"(printed)", ver_p, seq_p, limit=float("inf"))
            del ver_p, seq_p
        c32, p32 = fp32_tree(torch, cfg, p)
        ref = chunk_logits(torch, c32, p32, case, k1)
        del p32
        for path, x in (("verify", ver), ("sequential", seq)):
            out[f"{label}_{path}_vs_fp32"] = _parity(
                f"  {path} [{label} weights] vs the fp32 evaluation of the same weights", x, ref)
        del ver, seq, ref, p
        torch.cuda.empty_cache()
    del case
    torch.cuda.empty_cache()
    return out


def phase_spec_serve(card: str, weights: dict, verify_products: dict) -> dict:
    """Self-draft speculative decoding at llama3-8b width and full depth,
    random bf16 weights: 8 concurrent streams of SPEC_TOKENS over prompts
    that repeat a phrase, bf16 and then ``quantize="int8"``, each with
    ``spec_k`` = SPEC_K and 0 (fresh engines over the same weights). Holds:
    drafted and accepted tokens in both; each spec-on wave's launches, with
    every count set to 0 just before it: 225 W8A16 products per verify
    dispatch and decode step of the int8 engine, none of the bf16 one, 32
    paged calls per decode step; then :func:`verify_parity`. Prints the
    accept rate, tokens per verify dispatch, one verify and one decode
    dispatch's device time, TTFT and tok/s with speculation on and off,
    stream agreement, and the 225 int8 products of a verify dispatch as
    phase 4 timed them at M = 40 (``verify_products``)."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.ops import int8_matmul
    from dynamo_tpu_torch.ops.int8_matmul import int8_weight_matmul, plan_int8
    from dynamo_tpu_torch.ops.paged_attention import device_launches as paged_device_launches
    from dynamo_tpu_torch.ops.paged_attention import paged_decode_attention

    params, cfg, ecfg = weights["params"], weights["cfg"], weights["ecfg"]
    rng = np.random.default_rng(13)
    prompts = repeating_prompts(rng, cfg.vocab_size)
    k1 = SPEC_K + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for quant in (None, "int8"):
        label = quant or "bf16"
        waves = {}
        for k in (SPEC_K, 0):
            core = fresh_engine(params, cfg, ecfg, quantize=quant, spec_k=k)
            reset_all_counts()
            wave = engine_wave(core, prompts, SPEC_TOKENS)
            m = core.metrics_snapshot()
            wave.update(drafted=m["spec_drafted_tokens"], accepted=m["spec_accepted_tokens"],
                        verify=m["verify_dispatches"], rate=m["spec_accept_rate"],
                        verify_tokens=core.verify_tokens, decode_dispatches=m["decode_dispatches"],
                        chunks=core.chunk_dispatches, decode_steps=core.decode_steps_total,
                        int8_launches=int8_weight_matmul.launches,
                        int8_kernels={n: c for n, c in int8_matmul.device_launches.items() if c},
                        paged_launches=paged_decode_attention.launches,
                        paged_kernels={n: c for n, c in paged_device_launches.items() if c})
            if k:
                vprof, dprof = profile_dispatches(
                    core, [len(p) + SPEC_TOKENS // 2 for p in prompts], k1)
                wave.update(verify_profile=vprof, decode_profile=dprof)
            close_engine(core)
            waves[k] = wave
        on, off = waves[SPEC_K], waves[0]
        agree = sum(a == b for a, b in zip(on["tokens"], off["tokens"]))
        firsts = [first_difference(a, b) for a, b in zip(on["tokens"], off["tokens"])]
        vprof, dprof = on["verify_profile"], on["decode_profile"]
        print(f"spec serve [{label}, spec_k {SPEC_K}]: {N_REQUESTS} streams of {SPEC_TOKENS}; "
              f"drafted {on['drafted']}, accepted {on['accepted']} (accept rate EMA "
              f"{on['rate']:.3f}, overall {on['accepted'] / max(on['drafted'], 1):.3f}), "
              f"{on['verify']} verify dispatches emitting {on['verify_tokens']} tokens "
              f"({on['verify_tokens'] / max(on['verify'], 1):.2f} per dispatch, "
              f"{on['verify_tokens'] / max(on['verify'], 1) / N_REQUESTS:.2f} per lane), "
              f"{on['decode_dispatches']} decode dispatches; TTFT p50 {on['ttft_p50_ms']:.1f} "
              f"vs {off['ttft_p50_ms']:.1f} ms, decode {on['decode_tok_s']:.1f} vs "
              f"{off['decode_tok_s']:.1f} tok/s (spec on vs off); streams equal to spec off: "
              f"{agree} of {N_REQUESTS}, first difference at tokens {firsts} (not held), on {card}")
        if vprof["measured"]:
            print(f"spec serve [{label}]: one verify dispatch ({N_REQUESTS} lanes x {k1} "
                  f"positions, tables of {ecfg.max_model_len} tokens): device "
                  f"{vprof['device_ms']:.3f} ms, {vprof['kernels']} kernels, wall "
                  f"{vprof['wall_ms']:.3f} ms; one decode dispatch ({ecfg.decode_steps} steps): "
                  f"device {dprof['device_ms']:.3f} ms = {dprof['device_ms'] / ecfg.decode_steps:.3f} "
                  f"ms per step, {dprof['kernels']} kernels, wall {dprof['wall_ms']:.3f} ms")
            for name, ms in vprof["top"]:
                print(f"  verify device {ms:9.3f} ms  {name}")
        else:
            print(f"spec serve [{label}]: verify device time not measured (wall "
                  f"{vprof['wall_ms']:.3f} ms)")
        if on["drafted"] <= 0 or on["accepted"] <= 0 or on["verify"] <= 0:
            fail(f"spec serve [{label}]: drafted {on['drafted']}, accepted {on['accepted']}")
        # the wave's own launches: the int8 products of every verify and
        # decode step on the W8A16 kernels (prefill chunks run the bf16
        # tree in "int8"), 32 paged calls per decode step (verify attends
        # through forward_chunk)
        L, steps = cfg.num_layers, on["decode_steps"]
        want_int8 = INT8_LAUNCHES_PER_STEP * (on["verify"] + steps) if quant else 0
        print(f"spec serve [{label}]: the spec-on wave launched int8_weight_matmul "
              f"{on['int8_launches']} times (expected {INT8_LAUNCHES_PER_STEP} x ({on['verify']} "
              f"verify + {steps} decode steps) = {want_int8}), device launches "
              f"{on['int8_kernels']}; paged_decode_attention {on['paged_launches']} (expected "
              f"{L} x {steps} decode steps = {L * steps}), device launches {on['paged_kernels']}; "
              f"{on['chunks']} prefill chunks")
        if (on["int8_launches"] != want_int8 or sum(on["int8_kernels"].values()) != want_int8
                or on["paged_launches"] != L * steps
                or on["paged_kernels"].get("paged_decode_split_kernel") != L * steps):
            fail(f"spec serve [{label}]: the wave's launches differ from its dispatches'")
        if quant:
            M = N_REQUESTS * k1
            plans = {name: plan_label(plan_int8(M, N, K, sms)) for name, K, N, _, _ in INT8_SHAPES}
            print(f"spec serve [int8]: plans at M={M}: "
                  + "; ".join(f"{n}: {p}" for n, p in plans.items()))
            vp = verify_products
            print(f"spec serve [int8]: a verify dispatch's {INT8_LAUNCHES_PER_STEP} products at "
                  f"M={M} under these plans (phase 4): graph-replayed {vp['graph_ms']:.3f} ms, "
                  f"eager {vp['ms']:.3f} ms, bound {vp['bound_ms']:.3f} ms, bf16 torch.matmul "
                  f"{vp['library_graph_ms']:.3f} ms graph-replayed ({vp['library_ms']:.3f} eager), "
                  f"on {card}")
            out["verify_plans"] = plans
        out[label] = {key: on[key] for key in (
            "drafted", "accepted", "rate", "verify", "verify_tokens", "ttft_p50_ms",
            "decode_tok_s", "verify_profile", "decode_profile")}
        out[label].update(off_ttft_p50_ms=off["ttft_p50_ms"], off_decode_tok_s=off["decode_tok_s"],
                          streams_equal=agree, first_difference=firsts)
        out[label].update({key: on[key] for key in (
            "chunks", "decode_steps", "int8_launches", "int8_kernels", "paged_launches",
            "paged_kernels")})
    # verify vs sequential decode at full width
    out["verify_parity"] = verify_parity(torch, cfg, params, k1)
    return out


# -- phases 16-17: tensor parallelism (run after phase 13, before mixtral) -------

TP_8B = 2  # phase 16: llama3-8b over two co-located ranks
# phase 17: llama3-70b widths cut to TP_70B_LAYERS layers, over 8 ranks
TP_70B = 8
TP_70B_LAYERS = 4


# what phases 16 and 17 keep of a served wave
TP_SERVE_KEYS = ("ttft_p50_ms", "decode_tok_s", "decode_steps", "chunk_dispatches", "launches",
                 "sharded_launches", "kernel_launches", "splits", "collective_calls", "profile")


def param_gb(params) -> float:
    return sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9


def same_weights(sharded, params) -> bool:
    """Does every rank hold exactly its slice of the unsharded ``params``?"""
    import torch

    whole = dict(params.named_parameters())
    for name, rule in sharded.rules.items():
        for r, shard in enumerate(sharded.shards):
            if not torch.equal(shard.get_parameter(name), rule.shard(whole[name], r)):
                return False
    return True


def tp_build(card_dir: str, tp: int, devices: list, **kw):
    """A tp engine through the normal entry (``build_torch_serving_engine``
    with ``tensor_parallel_size`` and ``devices``), warmed up, with its HTTP
    pipelines and the launcher's flags for ``http_server``."""
    from dynamo_tpu_torch.cli.run import build_parser, make_pipelines
    from dynamo_tpu_torch.engine_torch.engine import build_torch_serving_engine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    card = ModelDeploymentCard.from_local_path(card_dir)
    t0 = time.perf_counter()
    core = build_torch_serving_engine(card, max_batch_size=N_REQUESTS,
                                      tensor_parallel_size=tp, devices=devices, **kw)
    built = time.perf_counter() - t0
    core.warmup()
    flags = build_parser().parse_args([
        "--model-path", card_dir, "--host", "127.0.0.1", "--port", str(_free_port()),
        "--max-batch-size", str(N_REQUESTS), "--tensor-parallel-size", str(tp)])
    chat, comp = make_pipelines(card, core)
    return core, chat, comp, card.display_name, flags, built, time.perf_counter() - t0


def hold_tp_launches(label: str, out: dict, tp: int, layers: int) -> None:
    """The tp serve's counts: per decode step one sharded call per layer,
    one per-rank paged call (a split and a merge kernel) per rank and
    layer."""
    steps = out["decode_steps"]
    want = {"paged_decode_attention_sharded": layers * steps,
            "paged_decode_attention": tp * layers * steps,
            **{k: tp * layers * steps for k in out["kernel_launches"]}}
    got = {"paged_decode_attention_sharded": out["sharded_launches"],
           "paged_decode_attention": out["launches"], **out["kernel_launches"]}
    print(f"{label}: launches over {steps} decode steps {got}, expected {want}; "
          f"collectives {out['collective_calls']}")
    if got != want or steps == 0:
        fail(f"{label}: launches {got}, expected {want}")
    per = out["profile"].get("per_step", {})
    for k in ("paged_decode_split_kernel", "paged_decode_merge_kernel"):
        if per and per.get(k) != tp * layers:
            fail(f"{label}: {per.get(k)} {k} per profiled decode step, expected {tp * layers}")


def phase_tp_serve(card: str, weights: dict, served: dict) -> dict:
    """llama3-8b at full width and depth over a tp=2 mesh whose ranks share
    the card, bf16 random weights of phase 7's seed (checked equal to phase
    7's, kept from it in ``weights``), the integrity plane on: the HTTP
    service answers 8 streams of 32 tokens (launches held, texts against
    phase 7's printed, profile, peak memory); one prefill chunk's and one
    decode step's logits held against the unsharded forward on the same
    weights at 2e-2; then ``"int8"`` weights at tp=2 (one decode step held
    against the unsharded int8 tree, the per-rank products' plans printed,
    a wave's int8 launches held); then a host-tier wave that spills and
    re-hits (injected rank pages bit-equal to their spills, the crcs
    verified at the re-hit); then, where there are two cards, the same
    model with its ranks on two cards (NCCL) held against the co-located
    run. Each engine is freed before the next is built."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine_torch.engine import TorchServingEngine
    from dynamo_tpu_torch.models.llama import quantize_params_int8
    from dynamo_tpu_torch.ops import int8_matmul
    from dynamo_tpu_torch.ops.int8_matmul import int8_weight_matmul, plan_int8

    params, cfg, ecfg = weights["params"], weights["cfg"], weights["ecfg"]
    L = cfg.num_layers
    res = {}
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama3-8b-random"))
        core, chat, comp, name, flags, built, warm = tp_build(model_dir, TP_8B,
                                                              ["cuda:0"] * TP_8B)
        mesh = core.mesh
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        print(f"tp serve: llama3-8b tp={TP_8B} on {[str(d) for d in mesh.devices]}, engine "
              f"built in {built:.1f} s, warmed up in {warm:.1f} s; "
              f"{core.num_blocks} KV blocks per rank pool; {held - before:.2f} GB allocated "
              f"for the engine (weights and pools), {before:.2f} GB before it (phase 7's "
              f"{param_gb(params):.2f} GB of unsharded weights, kept for the parity checks)")
        if not same_weights(core.params, params):
            fail("tp serve: the tp engine's weights are not phase 7's, sharded")
        out = serve_and_count(card, "tp serve", core, chat, comp, name, flags)
    peak = torch.cuda.max_memory_allocated() / 1e9
    hold_tp_launches("tp serve", out, TP_8B, L)
    equal_texts = sum(a == b for a, b in zip(out["texts"], served["texts"]))
    per = out["profile"].get("per_step", {})
    print(f"tp serve: TTFT p50 {out['ttft_p50_ms']:.1f} ms, decode {out['decode_tok_s']:.1f} "
          f"tok/s (phase 7 unsharded: {served['ttft_p50_ms']:.1f} ms, "
          f"{served['decode_tok_s']:.1f} tok/s); texts equal to phase 7's: {equal_texts} of "
          f"{N_REQUESTS} (not held); per decode step: all_reduce "
          f"{per.get('all_reduce', 0):.1f}, all_gather {per.get('all_gather', 0):.1f}; peak "
          f"memory while serving {peak:.2f} GB, of which {before:.2f} GB phase 7's weights")
    core.close()
    tp_params = core.params
    del core
    gc.collect()
    torch.cuda.empty_cache()
    res.update(serve={k: out[k] for k in TP_SERVE_KEYS}, texts_equal_phase7=equal_texts,
               peak_gb=peak)

    # one prefill chunk and one decode step against the unsharded forward,
    # each from the pool the unsharded prefill wrote (split over the ranks)
    chunk = []
    case = parity_case(torch, cfg, params, last_chunk=chunk)
    res["chunk_ratio"] = _parity(
        f"tp={TP_8B} prefill chunk logits against the unsharded forward (llama3-8b, "
        f"{chunk[0].shape[0]} live positions, one pool state)",
        last_chunk_logits(torch, cfg, tp_params, tp_case(torch, case, mesh)), chunk[0])
    del chunk
    res["decode_ratio"] = _parity(
        f"tp={TP_8B} decode step logits against the unsharded forward (llama3-8b, 8 lanes, "
        f"one pool state)", window_logits(torch, cfg, tp_params, tp_case(torch, case, mesh), None),
        window_logits(torch, cfg, params, case, None))

    # "int8" weights at tp=2: the sharded quantization, one decode step
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {f"{k}->{n}": plan_label(plan_int8(N_REQUESTS, n, k, sms))
             for _, k, n, *_ in INT8_TP2_SHAPES}
    print("tp int8: plan_int8 at M = 8 per rank shape: "
          + ", ".join(f"{k}: {v}" for k, v in plans.items()))
    core = TorchServingEngine(cfg, tp_params, dataclasses.replace(ecfg, quantize="int8"),
                              mesh=mesh)
    core.warmup()
    rng = np.random.default_rng(16)
    prompts = token_prompts(rng, rng.integers(100, 500, size=N_REQUESTS), cfg.vocab_size)
    reset_all_counts()
    s0 = core.decode_steps_total
    wave = engine_wave(core, prompts, MAX_TOKENS)
    steps = core.decode_steps_total - s0
    per_step = TP_8B * (INT8_LAUNCHES_PER_STEP - 1) + TP_8B  # each rank's 224 + its LM head
    int8_launches = int8_weight_matmul.launches
    int8_kernels = {k: n for k, n in int8_matmul.device_launches.items() if n}
    print(f"tp int8: {N_REQUESTS} streams of {MAX_TOKENS} tokens through generate, TTFT p50 "
          f"{wave['ttft_p50_ms']:.1f} ms, decode {wave['decode_tok_s']:.1f} tok/s; "
          f"int8_weight_matmul launches {int8_launches} over {steps} decode steps "
          f"(expected {per_step} per step), device launches {int8_kernels}")
    if any(len(t) != MAX_TOKENS for t in wave["tokens"]) or steps == 0 \
            or int8_launches != per_step * steps:
        fail(f"tp int8: {int8_launches} int8 launches over {steps} steps, expected "
             f"{per_step} per step")
    q_whole = quantize_params_int8(params, cfg)
    res["int8_decode_ratio"] = _parity(
        f"tp={TP_8B} \"int8\" decode step against the unsharded int8 tree (llama3-8b, 8 lanes, "
        f"one pool state)", window_logits(torch, cfg, core.params_decode,
                                          tp_case(torch, case, mesh), None),
        window_logits(torch, cfg, q_whole, case, None))
    res.update(int8_plans=plans, int8_launches_per_step=int8_launches / max(steps, 1),
               int8_ttft_p50_ms=wave["ttft_p50_ms"], int8_decode_tok_s=wave["decode_tok_s"])
    core.close()
    del core
    gc.collect()
    torch.cuda.empty_cache()
    res["int8_all"] = tp_int8_all_serve(card, cfg, q_whole, case)
    del q_whole
    gc.collect()
    torch.cuda.empty_cache()

    # a host-tier wave that spills and re-hits: phase 12's three-wave layout
    lens = [int(n) for n in rng.integers(100, ecfg.prefill_chunk + 1, size=N_REQUESTS)]
    prompts = token_prompts(rng, lens, cfg.vocab_size)
    evicting = token_prompts(rng, lens, cfg.vocab_size)
    blocks = sum(-(-(n + MAX_TOKENS + 2 * ecfg.decode_steps) // ecfg.kv_block_size) + 1
                 for n in lens) + 16
    core = TorchServingEngine(cfg, tp_params, dataclasses.replace(
        ecfg, num_kv_blocks=blocks, host_cache_blocks=4 * blocks), mesh=mesh)
    core.warmup()
    probe = host_tier_probe(core)
    waves = three_waves(core, prompts, evicting)
    print(f"tp host tier: pool of {blocks} blocks per rank, host tier {4 * blocks}; "
          f"{probe['spilled']} blocks spilled, third wave {waves['host_hits']} host hits, "
          f"{probe['injected']} pages injected, {probe['mismatched']} not bit-equal to their "
          f"spill (the rank pools in global head order), {waves['corrupted']} host entries "
          f"failing their crc, {waves['kv_trips']} kv trips; third-wave tokens equal to the "
          f"first wave's: {sum(a == b for a, b in zip(waves['first'], waves['third']))} of "
          f"{N_REQUESTS} (not held)")
    if (waves["host_hits"] <= 0 or probe["injected"] <= 0 or probe["mismatched"]
            or waves["corrupted"] or waves["kv_trips"]):
        fail("tp host tier")
    res["host_tier"] = dict(spilled=probe["spilled"], injected=probe["injected"],
                            mismatched=probe["mismatched"], host_hits=waves["host_hits"],
                            kv_trips=waves["kv_trips"], pool_blocks=blocks)
    close_engine(core)
    res["across_devices"] = tp_across_devices(card, cfg, tp_params, case)
    del tp_params, case
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_int8_all_serve(card: str, cfg, q_whole, case) -> dict:
    """llama3-8b at full width and depth in ``"int8-all"`` over a tp=2 mesh
    whose ranks share the card: the int8 tree drawn onto the ranks by
    ``build_torch_serving_engine(quantize="int8-all",
    tensor_parallel_size=2)`` from phase 7's seed, checked equal to
    ``q_whole`` (phase 7's weights quantized whole) sharded; the HTTP
    service answers 8 streams of 32 tokens (held: 7 W8A16 launches per
    layer and rank and each rank's LM head, per decode step and per prefill
    chunk; one sharded paged call per layer and decode step); then one
    prefill chunk and one decode step over ``case``'s pool held against the
    unsharded ``"int8-all"`` forward of ``q_whole`` at 2e-2."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama3-8b-random"))
        core, chat, comp, name, flags, built, warm = tp_build(
            model_dir, TP_8B, ["cuda:0"] * TP_8B, quantize="int8-all")
        mesh = core.mesh
        held = torch.cuda.memory_allocated() / 1e9 - before
        print(f"tp int8-all: llama3-8b tp={TP_8B} co-located, \"int8-all\" drawn onto the ranks, "
              f"engine built in {built:.1f} s, warmed up in {warm:.1f} s; {held:.2f} GB "
              f"allocated for the engine ({sum(param_gb(p) for p in core.params.shards):.2f} GB "
              f"of int8 weights), {before:.2f} GB before it")
        if not core.params.int8 or core.params_decode is not core.params:
            fail("tp int8-all: the engine does not serve one int8 tree")
        if not same_weights(core.params, q_whole):
            fail("tp int8-all: the ranks do not hold phase 7's weights quantized, sharded")
        torch.cuda.reset_peak_memory_stats()
        out = serve_and_count(card, "tp int8-all serve", core, chat, comp, name, flags)
    del chat, comp  # the pipelines hold the engine
    peak = torch.cuda.max_memory_allocated() / 1e9
    hold_tp_launches("tp int8-all serve", out, TP_8B, cfg.num_layers)
    steps, chunks = out["decode_steps"], out["chunk_dispatches"]
    want = TP_8B * INT8_LAUNCHES_PER_STEP * (steps + chunks)
    print(f"tp int8-all serve: int8_weight_matmul launches {out['int8_launches']} over {steps} "
          f"decode steps and {chunks} prefill chunks, expected {want} ({INT8_LAUNCHES_PER_STEP} "
          f"per rank and forward); int8 device launches {out['int8_kernel_launches']}; peak "
          f"memory while serving {peak:.2f} GB")
    if out["int8_launches"] != want or chunks == 0:
        fail(f"tp int8-all serve: {out['int8_launches']} int8 launches, expected {want}")
    core.close()
    tp_params = core.params
    del core
    gc.collect()
    torch.cuda.empty_cache()
    res = {k: out[k] for k in TP_SERVE_KEYS}
    res.update(int8_launches=out["int8_launches"], int8_kernel_launches=out["int8_kernel_launches"],
               peak_gb=peak)
    tcase = tp_case(torch, case, mesh)
    res["chunk_ratio"] = _parity(
        f"tp={TP_8B} \"int8-all\" prefill chunk against the unsharded \"int8-all\" forward "
        f"(llama3-8b, one pool state)", last_chunk_logits(torch, cfg, tp_params, tcase),
        last_chunk_logits(torch, cfg, q_whole, case))
    res["decode_ratio"] = _parity(
        f"tp={TP_8B} \"int8-all\" decode step against the unsharded \"int8-all\" forward "
        f"(llama3-8b, 8 lanes, one pool state)", window_logits(torch, cfg, tp_params, tcase, None),
        window_logits(torch, cfg, q_whole, case, None))
    del tp_params, tcase
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_across_devices(card: str, cfg, colocated, case) -> dict:
    """Phase 16's tp=2 model with its ranks on cuda:0 and cuda:1 (the
    all-reduce through NCCL): its weights equal to the co-located ranks',
    8 streams through ``generate``, and one decode step over ``case``'s
    pool held against the co-located run at 2e-2. Not run on a machine with
    one card."""
    import numpy as np
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"tp across devices: not run ({n} device)")
        return {"run": False, "devices": n}
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama3-8b-random"))
        core, *_ = tp_build(model_dir, TP_8B, ["cuda:0", "cuda:1"])
    for a, b in zip(core.params.shards, colocated.shards):
        for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            if not torch.equal(x.to(y.device), y):
                fail(f"tp across devices: {name} differs from the co-located ranks'")
    rng = np.random.default_rng(17)
    wave = engine_wave(core, token_prompts(rng, [200] * N_REQUESTS, cfg.vocab_size), MAX_TOKENS)
    core.close()
    params, mesh = core.params, core.mesh
    del core
    ratio = _parity("tp=2 across cuda:0 and cuda:1 against the co-located ranks, one decode "
                    "step", window_logits(torch, cfg, params, tp_case(torch, case, mesh), None),
                    window_logits(torch, cfg, colocated, tp_case(torch, case, colocated.mesh),
                                  None))
    print(f"tp across devices: decode {wave['decode_tok_s']:.1f} tok/s on {card}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"run": True, "devices": n, "decode_ratio": ratio,
            "decode_tok_s": wave["decode_tok_s"]}


def phase_tp_70b(card: str) -> dict:
    """llama3-70b at full width, TP_70B_LAYERS layers, bf16 random weights,
    over a tp=8 mesh whose ranks share the card (~11 GB): the HTTP service
    answers 8 streams of 32 tokens (launches held, profile: the per-rank
    kernel's share of device time), then one decode step held against the
    unsharded forward on the same weights (drawn from the same seed on the
    same card, checked equal) at 2e-2."""
    import torch

    from dynamo_tpu_torch.models.llama import init_params

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama3-70b-4-layers"),
                                    num_layers=TP_70B_LAYERS, arch=LLAMA3_70B)
        core, chat, comp, name, flags, built, warm = tp_build(model_dir, TP_70B,
                                                              ["cuda:0"] * TP_70B)
        cfg = core.model_config
        weights_gb = sum(param_gb(shard) for shard in core.params.shards)
        held = torch.cuda.memory_allocated() / 1e9 - before
        torch.cuda.reset_peak_memory_stats()
        print(f"tp 70b: llama3-70b widths, {cfg.num_layers} layers, tp={TP_70B} co-located, "
              f"{weights_gb:.2f} GB of bf16 weights, {held:.2f} GB allocated for the engine "
              f"({before:.2f} GB before it), built in {built:.1f} s, warmed up in {warm:.1f} s")
        out = serve_and_count(card, "tp 70b serve", core, chat, comp, name, flags)
    peak = torch.cuda.max_memory_allocated() / 1e9
    hold_tp_launches("tp 70b serve", out, TP_70B, cfg.num_layers)
    core.close()
    tp_params, mesh = core.params, core.mesh
    del core
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    if not same_weights(tp_params, params):
        fail("tp 70b: the ranks do not hold the unsharded draw's slices")
    case = parity_case(torch, cfg, params)
    ratio = _parity(f"tp={TP_70B} decode step logits against the unsharded forward "
                    f"(llama3-70b widths, {cfg.num_layers} layers, 8 lanes, one pool state)",
                    window_logits(torch, cfg, tp_params, tp_case(torch, case, mesh), None),
                    window_logits(torch, cfg, params, case, None))
    del case
    del params, tp_params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tp 70b: peak memory while serving {peak:.2f} GB")
    return {"weights_gb": weights_gb, "peak_gb": peak, "decode_ratio": ratio,
            **{k: out[k] for k in TP_SERVE_KEYS}}


# -- phases 14, 15, 18: mixtral-8x7b in "int8-all" ----------------------------------

MIXTRAL_LOAD_LAYERS = 1  # the checkpoint's depth: mixtral-8x7b widths, ~3.4 GB of bf16
# int8_weight_matmul calls per forward of mixtral: wq, wk, wv, wo per layer and the LM head
MIXTRAL_DENSE_PER_STEP = 4 * MIXTRAL["layers"] + 1  # 129


def int8_quantized(w):
    """The absmax/127 int8 of an HF [out, in] matrix (the embedding per row
    too): (q [out, in] int8, s [out] fp32), written out here as the JAX
    ``quantize_params_int8`` defines it."""
    import torch

    wf = w.float()
    s = (wf.abs().amax(dim=1) / 127.0).clamp(min=1e-12)
    return torch.round(wf / s[:, None]).clamp(-127, 127).to(torch.int8), s


def mixtral_checkpoint(torch, seed: int) -> dict:
    """Random bf16 weights on the card under the HF mixtral names, at
    mixtral-8x7b widths and MIXTRAL_LOAD_LAYERS layers."""
    c = MIXTRAL
    E, F, V, X = c["hidden"], c["ffn"], c["vocab"], c["experts"]
    q, kv = c["heads"] * c["head_dim"], c["kv_heads"] * c["head_dim"]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") / shape[-1] ** 0.5).bfloat16()

    t = {"model.embed_tokens.weight": w(V, E)}
    for i in range(MIXTRAL_LOAD_LAYERS):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": 1 + w(E) * 4,
            p + "post_attention_layernorm.weight": 1 + w(E) * 4,
            p + "self_attn.q_proj.weight": w(q, E), p + "self_attn.k_proj.weight": w(kv, E),
            p + "self_attn.v_proj.weight": w(kv, E), p + "self_attn.o_proj.weight": w(E, q),
            p + "block_sparse_moe.gate.weight": w(X, E),
        })
        for x in range(X):
            e = f"{p}block_sparse_moe.experts.{x}."
            t.update({e + "w1.weight": w(F, E), e + "w3.weight": w(F, E),
                      e + "w2.weight": w(E, F)})
    t["model.norm.weight"] = 1 + w(E) * 4
    t["lm_head.weight"] = w(V, E)
    return t


def mixtral_pairs(params) -> list:
    """(tensor or int8 pair on the card, HF name, how it was loaded) for
    every parameter of an int8 mixtral tree: "int8" (q, s of the HF
    matrix), "T" (the router, transposed) or "" (a norm, as written)."""
    lp = params.layers
    pairs = [((params.embed_q, params.embed_s), "model.embed_tokens.weight", "int8"),
             ((params.lm_head_q, params.lm_head_s), "lm_head.weight", "int8"),
             (params.final_norm, "model.norm.weight", "")]
    attn = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}
    for i in range(MIXTRAL_LOAD_LAYERS):
        p = f"model.layers.{i}."
        pairs += [(lp["attn_norm"][i], p + "input_layernorm.weight", ""),
                  (lp["mlp_norm"][i], p + "post_attention_layernorm.weight", ""),
                  (lp["moe_router"][i], p + "block_sparse_moe.gate.weight", "T")]
        pairs += [((lp[f"{k}_q"][i], lp[f"{k}_s"][i]), f"{p}self_attn.{v}.weight", "int8")
                  for k, v in attn.items()]
        for x in range(MIXTRAL["experts"]):
            e = f"{p}block_sparse_moe.experts.{x}."
            pairs += [((lp[f"{k}_q"][i, x], lp[f"{k}_s"][i, x]), f"{e}{v}.weight", "int8")
                      for k, v in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2"))]
    return pairs


def phase_mixtral_load(card: str, path: str) -> dict:
    """A mixtral-8x7b-width checkpoint cut to 1 layer (bf16, HF
    ``block_sparse_moe`` names, two files) loaded straight to int8 by
    ``load_params(..., int8=True)``: every q and s bit-equal to the
    quantization of the tensors written; then served in ``"int8-all"``
    through ``build_torch_serving_engine`` and the HTTP pipeline."""
    import torch

    from dynamo_tpu_torch.cli.run import build_parser, make_pipelines
    from dynamo_tpu_torch.engine_torch.engine import build_torch_serving_engine
    from dynamo_tpu_torch.engine_torch.weights import config_from_card, load_params
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    write_model_dir(path, num_layers=MIXTRAL_LOAD_LAYERS, arch=MIXTRAL)
    tensors = mixtral_checkpoint(torch, 41)
    names = list(tensors)
    split = names.index("model.layers.0.block_sparse_moe.experts.4.w1.weight")
    t0 = time.perf_counter()
    nbytes = 0
    for i, part in enumerate((names[:split], names[split:])):
        nbytes += write_safetensors(os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"),
                                    {n: tensors[n].cpu() for n in part})
    write_s = time.perf_counter() - t0
    hf_card = ModelDeploymentCard.from_local_path(path)
    cfg = config_from_card(hf_card)
    if (cfg.num_experts, cfg.num_experts_per_tok) != (MIXTRAL["experts"], MIXTRAL["top_k"]):
        fail(f"mixtral load: config_from_card read {cfg.num_experts} experts, top "
             f"{cfg.num_experts_per_tok}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = load_params(hf_card, cfg, device="cuda", int8=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = mixtral_pairs(params)
    if len(pairs) != len(tensors) or not params.int8:
        fail(f"mixtral load: {len(pairs)} parameters checked, {len(tensors)} written")
    for got, hname, how in pairs:
        want = tensors[hname]
        if how == "int8":
            ok = all(torch.equal(a, b) for a, b in zip(got, int8_quantized(want)))
        else:
            want = want.T if how == "T" else want
            ok = got.shape == want.shape and torch.equal(got, want.to(got.dtype))
        if not ok:
            fail(f"mixtral load: {hname} differs on the card from the quantization of what "
                 f"was written")
    n_int8 = sum(1 for *_, how in pairs if how == "int8")
    print(f"mixtral load: {len(pairs)} parameters on the card from the {len(tensors)} tensors "
          f"written (mixtral-8x7b widths, {MIXTRAL_LOAD_LAYERS} layer, bf16, 2 files): "
          f"{n_int8} int8 pairs bit-equal to the absmax/127 quantization of the tensors "
          f"written, the router and norms bit-equal as written; no bf16 matrix on the card")
    del params, tensors
    torch.cuda.empty_cache()
    flags = build_parser().parse_args(["--model-path", path, "--host", "127.0.0.1", "--port",
                                       str(_free_port()), "--max-batch-size", "2"])
    t0 = time.perf_counter()
    core = build_torch_serving_engine(hf_card, max_batch_size=2, quantize="int8-all")
    core.warmup()
    build_s = time.perf_counter() - t0
    try:
        chat, comp = make_pipelines(hf_card, core)
        with http_server(chat, comp, hf_card.display_name, flags) as port:
            run_streams(port, request_bodies(hf_card.display_name, 2, 8), 8)
        print("mixtral load: 2 streaming requests served over HTTP in \"int8-all\" from the "
              "loaded checkpoint")
    finally:
        core.close()
    print(f"mixtral load: {nbytes / 1e9:.3f} GB written in {write_s:.2f} s; load_params "
          f"(int8=True) to the card in {load_s:.2f} s = {nbytes / load_s / 1e9:.2f} GB/s of "
          f"bf16 read (files in the page cache); engine built and warmed up in {build_s:.2f} s; "
          f"on {card}")
    return {"gb": nbytes / 1e9, "load_s": load_s, "gb_s": nbytes / load_s / 1e9,
            "write_s": write_s, "build_engine_s": build_s}


def phase_mixtral_serve(card: str, model_dir: str) -> dict:
    """mixtral-8x7b at full width and depth, random weights drawn straight
    to int8 on the card (``init_params_int8``, through
    ``build_torch_serving_engine(quantize="int8-all")``), behind
    ``cli.run``'s HTTP server: 8 concurrent streams with every launch count
    checked against the decode steps and prefill chunks that ran."""
    import torch

    from dynamo_tpu_torch.cli.run import build_parser, make_pipelines
    from dynamo_tpu_torch.engine_torch.engine import build_torch_serving_engine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    write_model_dir(model_dir, num_layers=MIXTRAL["layers"], arch=MIXTRAL)
    mcard = ModelDeploymentCard.from_local_path(model_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    core = build_torch_serving_engine(mcard, max_batch_size=N_REQUESTS, quantize="int8-all")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    core.warmup()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params = dict(core.params.named_parameters())
    weights = sum(p.numel() * p.element_size() for p in params.values())
    kv = sum(t.numel() * t.element_size() for t in core.cache.values())
    bf16 = [n for n, p in params.items() if p.dtype == torch.bfloat16]
    print(f"mixtral serve: {core.model_config.num_layers} layers, {core.model_config.num_experts} "
          f"experts, int8 tree drawn on the card in {build_s:.1f} s ({weights / 1e9:.2f} GB of "
          f"weights, {kv / 1e9:.2f} GB of KV in {core.num_blocks} blocks), warmed up in "
          f"{warm_s:.1f} s; peak memory allocated {peak / 1e9:.2f} GB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; bf16 parameters: "
          f"{len(bf16)}")
    if bf16 or not core.params.int8 or core.params_decode is not core.params:
        fail(f"mixtral serve: the tree is not int8 alone ({bf16[:4]})")
    if peak > 80e9:
        fail(f"mixtral serve: peak memory {peak / 1e9:.2f} GB is over 80 GB")
    flags = build_parser().parse_args(["--model-path", model_dir, "--host", "127.0.0.1",
                                       "--port", str(_free_port()), "--max-batch-size",
                                       str(N_REQUESTS)])
    chat, comp = make_pipelines(mcard, core)
    out = serve_and_count(card, "mixtral serve", core, chat, comp, mcard.display_name, flags)
    steps, chunks = out["decode_steps"], out["chunk_dispatches"]
    want = {"int8_weight_matmul": MIXTRAL_DENSE_PER_STEP * (steps + chunks),
            "int8_expert_matmul": EXPERT_LAUNCHES_PER_STEP * (steps + chunks),
            "paged_decode_attention": MIXTRAL["layers"] * steps}
    got = {"int8_weight_matmul": out["int8_launches"],
           "int8_expert_matmul": out["expert_launches"],
           "paged_decode_attention": out["launches"]}
    # decode (8 lanes, C = 4) on the split-K kernel; a 1024-row chunk's dense
    # products on the tile kernel, but for its LM head, which runs on the 8
    # sampled rows alone (split-K), and its expert products (C = 512) on the
    # expert tile kernel
    per_forward = MIXTRAL_DENSE_PER_STEP + EXPERT_LAUNCHES_PER_STEP
    want_kernels = {"w8a16_splitk_kernel": per_forward * steps + chunks,
                    "w8a16_tile_kernel": (MIXTRAL_DENSE_PER_STEP - 1) * chunks,
                    "w8a16_expert_tile_kernel": EXPERT_LAUNCHES_PER_STEP * chunks}
    want_kernels = {k: n for k, n in want_kernels.items() if n}
    print(f"mixtral serve: {steps} decode steps and {chunks} prefill chunks: launches {got}, "
          f"expected {want} ({MIXTRAL_DENSE_PER_STEP} int8_weight_matmul, "
          f"{EXPERT_LAUNCHES_PER_STEP} int8_expert_matmul per forward; {MIXTRAL['layers']} "
          f"paged per decode step); int8 device launches {out['int8_kernel_launches']}, "
          f"expected {want_kernels}")
    if got != want or steps == 0 or chunks == 0 or out["int8_kernel_launches"] != want_kernels:
        fail("mixtral serve: the launch counts do not match the steps that ran")
    out.update(core=core, build_s=build_s, warmup_s=warm_s, peak_gb=peak / 1e9,
               weights_gb=weights / 1e9, kv_gb=kv / 1e9)
    return out


@contextmanager
def plain_experts():
    """Route the MoE layer's int8 expert products through the plain version."""
    import dynamo_tpu_torch.ops.moe as moe
    from dynamo_tpu_torch.ops.int8_matmul import int8_expert_matmul, int8_expert_matmul_plain

    moe.int8_expert_matmul = int8_expert_matmul_plain
    try:
        yield
    finally:
        moe.int8_expert_matmul = int8_expert_matmul


@contextmanager
def recorded_routes(into: list):
    """Append each MoE call's (top-k expert choices [N, K], router logits
    [N, X]) to ``into``."""
    import dynamo_tpu_torch.ops.moe as moe

    route = moe.route

    def recording(router, cfg, xt):
        probs, top_p, top_idx = route(router, cfg, xt)
        into.append((top_idx.cpu(), (xt.float() @ router).cpu()))
        return probs, top_p, top_idx

    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


@contextmanager
def forced_routes(routes: list):
    """Send each MoE call's tokens to the experts another run chose there
    (``routes`` as ``recorded_routes`` wrote them, in call order), with this
    run's own router weights over those experts."""
    import dynamo_tpu_torch.ops.moe as moe

    route = moe.route
    calls = iter(routes)

    def forced(router, cfg, xt):
        probs, _, _ = route(router, cfg, xt)
        top_idx = next(calls)[0].to(xt.device)
        top_p = probs.gather(-1, top_idx)
        return probs, top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9), top_idx

    moe.route = forced
    try:
        yield
    finally:
        moe.route = route


def routing_compare(cfg, kern_routes: list, other_routes: list) -> dict:
    """(layer, lane) routing choices of two full-depth runs: the ordered
    top-k of each lane at each layer, which lanes agree at every layer, and
    for each lane's first differing layer the kernel run's router-logit
    gaps (first-second, second-third) and the largest change of a router
    logit between the runs: a flip at a near-tie shows a small gap."""
    if not len(kern_routes) == len(other_routes) == cfg.num_layers:
        fail(f"mixtral parity: {len(kern_routes)} and {len(other_routes)} MoE calls recorded")
    import torch

    same = torch.stack([(a[0] == b[0]).all(dim=-1) for a, b in zip(kern_routes, other_routes)])
    agree = same.all(dim=0)
    flips = []
    for lane in range(same.shape[1]):
        if agree[lane]:
            continue
        layer = int((~same[:, lane]).nonzero()[0])
        logits = kern_routes[layer][1][lane]
        top = logits.sort(descending=True).values
        moved = (logits - other_routes[layer][1][lane]).abs().max().item()
        flips.append(dict(lane=lane, layer=layer, gap12=float(top[0] - top[1]),
                          gap23=float(top[1] - top[2]), max_logit_change=moved))
    return {"differ": int((~same).sum()), "agree": agree, "n_agree": int(agree.sum()),
            "first_flips": flips}


def mixtral_chunk_ms(torch, cfg, params, case) -> dict:
    """One full-depth mixtral ``"int8-all"`` prefill chunk (8 lanes x 128
    tokens from position 0, ``forward_chunk``), ms by CUDA events, the
    median of 3 after a warm run: the expert products on the planner's
    kernel (the expert tile kernel at C = 512) and forced onto the dense
    tile kernel, in the order expert tile, tile, tile, expert tile."""
    import dynamo_tpu_torch.ops.moe as moe
    from dynamo_tpu_torch.models.llama import forward_chunk, make_kv_cache
    from dynamo_tpu_torch.ops.int8_matmul import int8_expert_matmul, plan_int8

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    toks = case[4][:, :128].contiguous()
    pos = torch.arange(128, device="cuda", dtype=torch.int32)[None, :].repeat(8, 1)
    tables = case[1]

    def tile_kernel(x, q, s, **kw):
        plan = plan_int8(x.shape[1], q.shape[1], x.shape[2], sms, path="tile", experts=x.shape[0])
        return int8_expert_matmul(x, q, s, plan=plan, **kw)

    runs = {"expert_tile": [], "tile": []}
    for label in ("expert_tile", "tile", "tile", "expert_tile"):
        moe.int8_expert_matmul = tile_kernel if label == "tile" else int8_expert_matmul
        try:
            cache = make_kv_cache(cfg, tables.numel(), 16, device="cuda")
            times = []
            for _ in range(4):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                with torch.no_grad():
                    forward_chunk(params, cfg, toks, pos, cache, tables, with_history=False)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            runs[label].append(statistics.median(times[1:]))
            del cache
        finally:
            moe.int8_expert_matmul = int8_expert_matmul
    print(f"mixtral prefill chunk (forward_chunk, 32 layers, 8 lanes x 128 tokens, eager): expert "
          f"products on the expert tile kernel {runs['expert_tile'][0]:.2f} / "
          f"{runs['expert_tile'][1]:.2f} ms, on the dense tile kernel {runs['tile'][0]:.2f} / "
          f"{runs['tile'][1]:.2f} ms (in turns: expert tile, tile, tile, expert tile)")
    return {k: statistics.mean(v) for k, v in runs.items()} | {"runs": runs}


def phase_mixtral_parity(params, cfg) -> dict:
    """Kernel against plain at mixtral-8x7b width in int8: one MoE layer at
    8 and 1024 tokens (the same input, so the same routing), then one
    full-depth ``forward_window`` step through the kernels, held against
    the same step with every kernel's plain version, and against the step
    with the int8 products' plain versions and the paged kernel (as phase
    10 holds the int8 products). For each, the (layer, lane) routing
    choices that differ are counted, and the logits are held on the lanes
    whose choices agree at every layer, which must be at least half of
    them; then the kernels' step is run again with every MoE layer sending
    each lane to the experts the plain run chose, and the logits are held
    on all lanes, each lane on its own as well. Last, a prefill chunk is
    timed on either expert kernel (:func:`mixtral_chunk_ms`)."""
    import torch

    from dynamo_tpu_torch.models.llama import moe_config
    from dynamo_tpu_torch.ops.int8_matmul import int8_expert_matmul
    from dynamo_tpu_torch.ops.moe import moe_mlp
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    lp = params.layer(0)
    moe_params = {"router": lp["moe_router"], "w_gate": lp["w_gate"], "w_up": lp["w_up"],
                  "w_down": lp["w_down"]}
    gen = torch.Generator(device="cuda").manual_seed(12)
    layer = {}
    for b, t in ((8, 1), (8, 128)):
        x = torch.randn((b, t, cfg.hidden_size), generator=gen, device="cuda").bfloat16()
        valid = torch.ones((b, t), dtype=torch.bool, device="cuda")
        reset_all_counts()
        with torch.no_grad():
            kern, _ = moe_mlp(moe_params, moe_config(cfg), x, token_valid=valid)
            torch.cuda.synchronize()
            launched = int8_expert_matmul.launches
            with plain_experts():
                plain, _ = moe_mlp(moe_params, moe_config(cfg), x, token_valid=valid)
        if launched != 3:
            fail(f"mixtral MoE layer: {launched} expert launches, expected 3")
        layer[b * t] = _parity(f"mixtral MoE layer parity (layer 0 of the int8 tree, {b * t} "
                               f"tokens, C={moe_config(cfg).capacity(b * t)}, kernel vs plain "
                               f"expert products; output)", kern.float(), plain.float())
    case = parity_case(torch, cfg, params)
    routes = [], [], []
    with recorded_routes(routes[0]):
        kern = window_logits(torch, cfg, params, case, paged_decode_attention)
    with recorded_routes(routes[1]), plain_int8(), plain_experts():
        plain = {"all": window_logits(torch, cfg, params, case, paged_decode_attention_plain)}
    with recorded_routes(routes[2]), plain_int8(), plain_experts():
        plain["int8"] = window_logits(torch, cfg, params, case, paged_decode_attention)
    lanes = kern.shape[0]
    lens = case[5]
    out = {}
    for key, label, other in (("all", "every kernel against its plain version", routes[1]),
                              ("int8", "the int8 products against their plain version, the "
                                       "paged kernel in both runs", routes[2])):
        c = routing_compare(cfg, routes[0], other)
        print(f"mixtral decode routing [{label}]: {c['differ']} of {cfg.num_layers * lanes} "
              f"(layer, lane) routing choices differ; {c['n_agree']} of {lanes} lanes agree at "
              f"every layer; first differing layer per lane, with the kernel run's router-logit "
              f"gaps (1st-2nd, 2nd-3rd) there and the largest router-logit change: "
              + "; ".join(f"lane {f['lane']} layer {f['layer']} gaps {f['gap12']:.4f}, "
                          f"{f['gap23']:.4f}, change {f['max_logit_change']:.4f}"
                          for f in c["first_flips"]))
        if 2 * c["n_agree"] < lanes:
            fail(f"mixtral parity [{label}]: only {c['n_agree']} of {lanes} lanes route alike "
                 f"at every layer")
        agree = c["agree"]
        c["ratio"] = _parity(f"mixtral decode parity (forward_window of the int8 tree, 32 layers, "
                             f"{label}; the {c['n_agree']} lanes that route alike; lengths "
                             f"{int(lens.min())}-{int(lens.max())})",
                             kern[agree], plain[key][agree])
        c["agree"] = agree.tolist()
        # every lane: the kernels fed the plain run's expert choices at each
        # layer, so that no near-tie flips a lane away (ROADMAP C2)
        forced_run = []
        with forced_routes(other), recorded_routes(forced_run):  # records what was forced
            both = window_logits(torch, cfg, params, case, paged_decode_attention)
        if routing_compare(cfg, forced_run, other)["n_agree"] != lanes:
            fail(f"mixtral parity [{label}]: the forced routing was not followed")
        c["forced_ratio"] = _parity(f"mixtral decode parity, all {lanes} lanes (forward_window of "
                                    f"the int8 tree, 32 layers, {label}; the kernels' run routed "
                                    f"to the plain run's top-{cfg.num_experts_per_tok} at every "
                                    f"layer)", both, plain[key])
        lane_ratios = [((both[i] - plain[key][i]).abs().max()
                        / plain[key][i].abs().max().clamp(min=1e-30)).item()
                       for i in range(lanes)]
        print(f"  per lane max|dlogits| / max|logits|: "
              + ", ".join(f"{r:.3e}" for r in lane_ratios) + " (limit 0.02 each)")
        if not max(lane_ratios) <= 2e-2:
            fail(f"mixtral parity [{label}]: a lane over 2e-2 with the routing forced")
        c["forced_lane_ratios"] = lane_ratios
        out[key] = c
    return {"layer_ratio": layer, "window": out, "lanes": lanes,
            "chunk_ms": mixtral_chunk_ms(torch, cfg, params, case)}


# -- phases 19-20: llama3-70b at full depth, mixtral-8x7b over tp=2 ---------------

# bytes the 70b phase leaves free beside its weights and KV pool: a
# prefill chunk's activations and attention temporaries, cuBLAS workspace
# and the integrity plane's page gathers
LLAMA70B_MARGIN = 5e9
LLAMA70B_CONTEXT = 2048
LLAMA70B_DEPTHS = (8, 16, 32)  # decode parity also printed at these depths
TP_MIXTRAL = 2


@contextmanager
def forced_residuals(plain_run: list, ratios=None):
    """The residual adds of a forward (``models/llama.py _residual``),
    recorded or forced. With ``ratios`` None each add's block output (the
    ranks' partials summed and rounded, as ``_residual`` adds it) and the
    stream after it are appended to ``plain_run`` on the host. Else each
    add appends max|d| / max|recorded| of its block output against the
    recorded one at the same index to ``ratios`` and returns the recorded
    stream: every attention and MLP block of this run starts from the
    recorded run's state, so that each block's kernels are compared on the
    same input instead of on a state that 80 layers of rounding noise have
    moved."""
    import dynamo_tpu_torch.models.llama as llama

    residual = llama._residual
    calls = iter(range(1 << 30))

    def recorded(hs, parts):
        o = llama.all_reduce(parts, hs[0].dtype)
        out = [h + x for h, x in zip(hs, o)]
        if ratios is None:
            plain_run.append((o[0].cpu(), out[0].cpu()))
            return out
        po, pout = plain_run[next(calls)]
        po = po.to(o[0].device)
        ratios.append(((o[0].float() - po.float()).abs().max()
                       / po.float().abs().max().clamp(min=1e-30)).item())
        return [pout.to(h.device) for h in hs]

    llama._residual = recorded
    try:
        yield
    finally:
        llama._residual = residual


def held_blockwise(label: str, run) -> dict:
    """``run(kernels: bool)`` -> logits, through the kernels or their plain
    versions. The free-running pair is printed (not held); then the plain
    run is recorded and the kernels' run forced onto it block by block
    (:func:`forced_residuals`): every block's output and the logits are
    held at 2e-2."""
    free = run(True), run(False)
    rel = ((free[0] - free[1]).abs().max() / free[1].abs().max()).item()
    print(f"{label}, free-running through every layer (not held: the noise floor below): "
          f"ratio {rel:.3e}")
    del free
    plain_run, ratios = [], []
    with forced_residuals(plain_run):
        plain = run(False)
    with forced_residuals(plain_run, ratios):
        kern = run(True)
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    print(f"{label}, block by block on the plain run's stream: {len(ratios)} attention and MLP "
          f"blocks, their outputs' max|d| / max|plain| up to {ratios[worst]:.3e} (block "
          f"{worst}: layer {worst // 2} {'MLP' if worst % 2 else 'attention'}), limit 0.02")
    if not max(ratios) <= 2e-2:
        fail(f"{label}: block {worst} through the kernels is {ratios[worst]:.3e} from its "
             f"plain version")
    logits = _parity(f"{label}, logits from the plain run's last stream", kern, plain)
    return {"free_running_ratio": rel, "block_ratio_max": max(ratios),
            "block_ratios": ratios, "logits_ratio": logits}


def llama70b_parity(torch, cfg, params) -> dict:
    """One decode step and one 1024-row prefill chunk of the 80-layer int8
    tree through the kernels against the same step through the kernels'
    plain versions (W8A16 products and paged decode), held block by block
    at 2e-2 (:func:`held_blockwise`). Printed, not held: the free-running
    decode ratio over the first 8, 16, 32 and 80 layers of the same
    weights, and the noise floor at each depth: the plain step against the
    same step with its W8A16 products summed in fp64; the chunk's
    free-running ratio beside its own floor, alike."""
    from dynamo_tpu_torch.models.llama import forward_chunk, make_kv_cache
    from dynamo_tpu_torch.ops.int8_matmul import device_launches
    from dynamo_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    case = parity_case(torch, cfg, params)
    lens = case[5]
    depths = {}
    for n in LLAMA70B_DEPTHS + (cfg.num_layers,):
        sub = dataclasses.replace(cfg, num_layers=n)
        kern = window_logits(torch, sub, params, case, paged_decode_attention)
        with plain_int8():
            plain = window_logits(torch, sub, params, case, paged_decode_attention_plain)
        with plain_int8(int8_weight_matmul_plain64):
            p64 = window_logits(torch, sub, params, case, paged_decode_attention_plain)
        top = plain.abs().max()
        depths[n] = {"kernels": ((kern - plain).abs().max() / top).item(),
                     "floor": ((p64 - plain).abs().max() / top).item()}
        print(f"llama3-70b decode over the first {n} layers (not held): kernels against plain "
              f"{depths[n]['kernels']:.3e}; noise floor (plain with fp64-summed products "
              f"against plain) {depths[n]['floor']:.3e}")
        del kern, plain, p64

    def decode(kernels: bool):
        if kernels:
            return window_logits(torch, cfg, params, case, paged_decode_attention)
        with plain_int8():
            return window_logits(torch, cfg, params, case, paged_decode_attention_plain)

    res = {"decode": held_blockwise(
        f"llama3-70b decode step (forward_window, 80 layers, \"int8-all\", the W8A16 and paged "
        f"kernels against their plain versions, 8 lanes, lengths "
        f"{int(lens.min())}-{int(lens.max())})", decode)}
    toks = case[4][:, :128].contiguous()
    pos = torch.arange(128, device="cuda", dtype=torch.int32)[None, :].repeat(8, 1)
    tables = case[1]
    launches = {}

    def chunk(kernels: bool, plain_fn=None):
        cache = make_kv_cache(cfg, tables.numel(), 16, device="cuda")
        reset_all_counts()
        with torch.no_grad(), (nullcontext() if kernels else plain_int8(plain_fn)):
            logits, _ = forward_chunk(params, cfg, toks, pos, cache, tables, with_history=False)
        torch.cuda.synchronize()
        if kernels:
            launches.update({k: n for k, n in device_launches.items() if n})
        return logits[:, -16:].float()

    res["chunk"] = held_blockwise("llama3-70b prefill chunk (forward_chunk, 80 layers, 8 lanes x "
                                  "128 tokens, the W8A16 kernels against their plain version; "
                                  "logits of the last 16 positions)", chunk)
    plain, p64 = chunk(False), chunk(False, int8_weight_matmul_plain64)
    floor = ((p64 - plain).abs().max() / plain.abs().max()).item()
    del plain, p64
    res["chunk"]["floor"] = floor
    print(f"llama3-70b prefill chunk over 80 layers (not held): kernels against plain "
          f"{res['chunk']['free_running_ratio']:.3e}; noise floor (plain with fp64-summed "
          f"products against plain) {floor:.3e}")
    print(f"llama3-70b prefill chunk: int8 device launches {launches} ({INT8_70B_PER_STEP} "
          f"products of 1024 rows)")
    if sum(launches.values()) != INT8_70B_PER_STEP:
        fail(f"llama3-70b prefill chunk: {launches} int8 launches, expected {INT8_70B_PER_STEP}")
    del case
    return {**res, "decode_ratio_by_depth": depths, "chunk_launches": launches}


def phase_llama70b(card: str) -> dict:
    """llama3-70b at full width and depth (80 layers) in ``"int8-all"`` on
    the one card: random weights drawn layer by layer straight to int8
    (``init_params_int8`` through ``build_torch_serving_engine``), the KV
    pool sized from the memory the weights leave free (at most the engine's
    own rule for 8 lanes of 2048 tokens). Prints the bytes allocated before
    the build, after it and at the serving peak beside ``mem_get_info``'s
    total; the HTTP service answers 8 streams of 32 tokens (held: 561
    ``int8_weight_matmul`` launches per decode step and prefill chunk, 80
    paged calls per decode step); TTFT p50, decode tok/s and a decode
    profile; then :func:`llama70b_parity`."""
    import math

    import torch

    from dynamo_tpu_torch.cli.run import build_parser, make_pipelines
    from dynamo_tpu_torch.engine_torch.engine import EngineConfig, build_torch_serving_engine
    from dynamo_tpu_torch.engine_torch.weights import config_from_card
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.llama import param_shapes

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "llama3-70b-random"),
                                    num_layers=LLAMA3_70B["layers"], arch=LLAMA3_70B)
        mcard = ModelDeploymentCard.from_local_path(model_dir)
        cfg = config_from_card(mcard)
        weights = sum(math.prod(shape) * (1 if dt == torch.int8 else 4)
                      for shape, dt in param_shapes(cfg, int8=True).values())
        block = 2 * cfg.num_layers * 16 * cfg.num_kv_heads * cfg.head_dim * 2
        rule = EngineConfig(max_slots=N_REQUESTS, kv_block_size=16,
                            max_model_len=LLAMA70B_CONTEXT).resolve_num_blocks()
        blocks = min(rule, int((free - weights - LLAMA70B_MARGIN) // block))
        print(f"llama3-70b: {cfg.num_layers} layers, {weights / 1e9:.2f} GB of int8 weights; the "
              f"card {total / 1e9:.2f} GB, {free / 1e9:.2f} GB free and {before / 1e9:.3f} GB "
              f"allocated before the build; KV pool {blocks} blocks of 16 = "
              f"{blocks * block / 1e9:.2f} GB (the engine's rule {rule}, {LLAMA70B_MARGIN / 1e9:.0f} "
              f"GB kept free)")
        if blocks < N_REQUESTS * (LLAMA70B_CONTEXT // 16):
            fail(f"llama3-70b: {blocks} KV blocks do not hold 8 lanes of {LLAMA70B_CONTEXT} tokens")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        core = build_torch_serving_engine(mcard, max_batch_size=N_REQUESTS, quantize="int8-all",
                                          max_model_len=LLAMA70B_CONTEXT, num_kv_blocks=blocks)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        after = torch.cuda.memory_allocated()
        build_peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        core.warmup()
        warm_s = time.perf_counter() - t0
        bf16 = [n for n, p in core.params.named_parameters() if p.dtype == torch.bfloat16]
        print(f"llama3-70b: int8 tree drawn on the card in {build_s:.1f} s, warmed up in "
              f"{warm_s:.1f} s; allocated after the build {after / 1e9:.2f} GB (peak while "
              f"drawing {build_peak / 1e9:.2f} GB); bf16 parameters: {len(bf16)}")
        if bf16 or not core.params.int8 or core.params_decode is not core.params:
            fail("llama3-70b: the tree is not int8 alone")
        torch.cuda.reset_peak_memory_stats()
        flags = build_parser().parse_args([
            "--model-path", model_dir, "--host", "127.0.0.1", "--port", str(_free_port()),
            "--max-batch-size", str(N_REQUESTS), "--quantize", "int8-all",
            "--max-model-len", str(LLAMA70B_CONTEXT)])
        chat, comp = make_pipelines(mcard, core)
        out = serve_and_count(card, "llama3-70b serve", core, chat, comp, mcard.display_name,
                              flags)
    del chat, comp  # the pipelines hold the engine, and with it the KV pool
    peak = torch.cuda.max_memory_allocated()
    steps, chunks = out["decode_steps"], out["chunk_dispatches"]
    want = {"int8_weight_matmul": INT8_70B_PER_STEP * (steps + chunks),
            "paged_decode_attention": cfg.num_layers * steps, "int8_expert_matmul": 0}
    got = {"int8_weight_matmul": out["int8_launches"],
           "paged_decode_attention": out["launches"],
           "int8_expert_matmul": out["expert_launches"]}
    print(f"llama3-70b serve: {steps} decode steps and {chunks} prefill chunks: launches {got}, "
          f"expected {want}; int8 device launches {out['int8_kernel_launches']}; allocated at "
          f"the serving peak {peak / 1e9:.2f} GB of the card's {total / 1e9:.2f} GB")
    if got != want or steps == 0 or chunks == 0:
        fail("llama3-70b serve: the launch counts do not match the steps that ran")
    core.close()
    params = core.params
    del core
    gc.collect()
    torch.cuda.empty_cache()
    res = {k: out[k] for k in TP_SERVE_KEYS if k in out}
    res.update(int8_launches=out["int8_launches"], int8_kernel_launches=out["int8_kernel_launches"],
               weights_gb=weights / 1e9, kv_blocks=blocks, kv_gb=blocks * block / 1e9,
               total_gb=total / 1e9, before_gb=before / 1e9, after_build_gb=after / 1e9,
               build_peak_gb=build_peak / 1e9, serve_peak_gb=peak / 1e9, build_s=build_s,
               warmup_s=warm_s)
    res.update(llama70b_parity(torch, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def fingerprint(t) -> tuple:
    """The sum of a tensor's bytes and their sum weighted by position (mod
    251, plus 1), over slices of its leading axis in 64 MB pieces: equal
    tensors give equal sums, and a wrong slice, offset or order almost
    surely does not."""
    import torch

    total = weighted = pos = 0
    for piece in (t if t.dim() > 1 else t[None]):
        u = piece.contiguous().view(torch.uint8).reshape(-1)
        for a in range(0, u.numel(), 1 << 26):
            c = u[a:a + (1 << 26)].to(torch.int64)
            w = torch.arange(pos, pos + c.numel(), device=c.device, dtype=torch.int64) % 251 + 1
            total += int(c.sum())
            weighted += int((c * w).sum())
            pos += c.numel()
    return total, weighted


def phase_mixtral_tp(card: str) -> dict:
    """mixtral-8x7b at full width and depth in ``"int8-all"`` over a tp=2
    mesh whose ranks share the card (every expert at F/2 on each rank),
    random weights drawn onto the ranks through
    ``build_torch_serving_engine``: the HTTP service answers 8 streams of 32
    tokens (held per rank and forward: 129 ``int8_weight_matmul`` and 96
    ``int8_expert_matmul`` launches; one sharded paged call per layer and
    decode step); TTFT, tok/s and a profile. Then
    :func:`mixtral_tp_parity`."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, "mixtral-8x7b-random"),
                                    num_layers=MIXTRAL["layers"], arch=MIXTRAL)
        torch.cuda.reset_peak_memory_stats()
        core, chat, comp, name, flags, built, warm = tp_build(
            model_dir, TP_MIXTRAL, ["cuda:0"] * TP_MIXTRAL, quantize="int8-all")
        cfg, mesh = core.model_config, core.mesh
        weights_gb = sum(param_gb(p) for p in core.params.shards)
        build_peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"mixtral tp: mixtral-8x7b tp={TP_MIXTRAL} co-located, \"int8-all\" drawn onto the "
              f"ranks in {built:.1f} s (warmed up in {warm:.1f} s), {weights_gb:.2f} GB of "
              f"weights over the ranks, {core.num_blocks} KV blocks per rank pool; peak while "
              f"drawing {build_peak:.2f} GB, {before:.2f} GB before it; w_gate per rank "
              f"{tuple(core.params.shards[0].layers['w_gate_q'].shape)}")
        if not core.params.int8 or core.params_decode is not core.params:
            fail("mixtral tp: the engine does not serve one int8 tree")
        torch.cuda.reset_peak_memory_stats()
        out = serve_and_count(card, "mixtral tp serve", core, chat, comp, name, flags)
    del chat, comp  # the pipelines hold the engine, and with it the tp tree
    peak = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.num_layers
    hold_tp_launches("mixtral tp serve", out, TP_MIXTRAL, L)
    steps, chunks = out["decode_steps"], out["chunk_dispatches"]
    want = {"int8_weight_matmul": TP_MIXTRAL * MIXTRAL_DENSE_PER_STEP * (steps + chunks),
            "int8_expert_matmul": TP_MIXTRAL * EXPERT_LAUNCHES_PER_STEP * (steps + chunks)}
    got = {"int8_weight_matmul": out["int8_launches"],
           "int8_expert_matmul": out["expert_launches"]}
    print(f"mixtral tp serve: {steps} decode steps and {chunks} prefill chunks: launches {got}, "
          f"expected {want} (per rank and forward {MIXTRAL_DENSE_PER_STEP} and "
          f"{EXPERT_LAUNCHES_PER_STEP}); int8 device launches {out['int8_kernel_launches']}; "
          f"peak memory while serving {peak:.2f} GB")
    if got != want or chunks == 0:
        fail("mixtral tp serve: the launch counts do not match the steps that ran")
    core.close()
    handed = [core.params]
    del core
    gc.collect()
    torch.cuda.empty_cache()
    res = {k: out[k] for k in TP_SERVE_KEYS}
    res.update(int8_launches=out["int8_launches"], expert_launches=out["expert_launches"],
               int8_kernel_launches=out["int8_kernel_launches"], weights_gb=weights_gb,
               peak_gb=peak, build_peak_gb=build_peak)
    res.update(mixtral_tp_parity(torch, cfg, handed))
    return res


def mixtral_tp_parity(torch, cfg, handed: list) -> dict:
    """The parity of :func:`phase_mixtral_tp`. ``handed`` holds the tp tree
    alone, so that it is freed here before the unsharded tree is drawn.

    The tp run prefills a pool, then runs one prefill chunk and one decode
    step over it, recording its residual stream (:func:`forced_residuals`)
    and routing choices; pool, logits and records go to the host. The
    unsharded tree, drawn from the same seed, runs the same chunk and step
    on the same pool twice: free-running (its ratio and the routing choices
    that differ printed, not held: over 32 layers the two roundings move
    the stream far enough to flip near-tied routing choices), and forced
    onto the tp run's stream block by block, where both route alike by
    construction: every block's output and the logits held at 2e-2."""
    from dynamo_tpu_torch.models.llama import ShardedParams, init_params_int8

    tp_params = handed.pop()
    mesh, L = tp_params.mesh, cfg.num_layers
    prints = {(n, r): fingerprint(p) for r, shard in enumerate(tp_params.shards)
              for n, p in shard.named_parameters()}
    case = parity_case(torch, cfg, tp_params, mesh=mesh)
    runs = {}
    for key in ("chunk", "decode"):
        stream, routes = [], []
        with forced_residuals(stream), recorded_routes(routes):
            logits = (last_chunk_logits(torch, cfg, tp_params, case) if key == "chunk"
                      else window_logits(torch, cfg, tp_params, case, None)).cpu()
        # the ranks route alike: one choice per layer
        if any(not torch.equal(routes[i][0], routes[i + 1][0])
               for i in range(0, len(routes), TP_MIXTRAL)):
            fail(f"mixtral tp: the ranks routed the {key} differently")
        runs[key] = (logits, stream, routes[::TP_MIXTRAL])
    pool = {n: torch.cat([p[n] for p in case[0]], dim=3).cpu() for n in ("k", "v")}
    rest = case[1:]
    del case, tp_params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = init_params_int8(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    rules = ShardedParams(cfg, mesh, [params] * TP_MIXTRAL).rules
    whole = dict(params.named_parameters())
    for (n, r), fp in prints.items():
        if fingerprint(rules[n].shard(whole[n], r)) != fp:
            fail(f"mixtral tp: rank {r}'s {n} is not the unsharded draw's slice")
    print(f"mixtral tp: the unsharded \"int8-all\" tree drawn in {draw_s:.1f} s; every rank's "
          f"{len(prints) // TP_MIXTRAL} leaves fingerprint-equal to its slice of it")
    del whole
    case = ({n: t.cuda() for n, t in pool.items()}, *rest)
    del pool
    res = {"unsharded_draw_s": draw_s}
    for key in ("chunk", "decode"):
        tp_logits, stream, tp_routes = runs[key]

        def run():
            if key == "chunk":
                return last_chunk_logits(torch, cfg, params, case).cpu()
            return window_logits(torch, cfg, params, case, None).cpu()

        routes = []
        with recorded_routes(routes):
            free = run()
        c = routing_compare(cfg, tp_routes, routes)
        free_ratio = ((tp_logits - free).abs().max() / free.abs().max()).item()
        n = tp_routes[0][0].shape[0]
        flips = "; ".join(f"lane {f['lane']} layer {f['layer']} gaps {f['gap12']:.4f}, "
                          f"{f['gap23']:.4f}" for f in c["first_flips"]) if key == "decode" else ""
        print(f"mixtral tp {key}, free-running (not held): ratio {free_ratio:.3e}; {c['differ']} of "
              f"{L * n} (layer, token) routing choices differ; {c['n_agree']} of {n} tokens route "
              f"alike at every layer" + (f"; first differing layer per lane with the tp run's "
                                        f"router-logit gaps: {flips}" if flips else ""))
        ratios = []
        with forced_residuals(stream, ratios):
            forced = run()
        worst = max(range(len(ratios)), key=ratios.__getitem__)
        label = (f"mixtral tp={TP_MIXTRAL} {key} against the unsharded \"int8-all\" forward "
                 f"(32 layers, one pool state)")
        print(f"{label}, block by block on the tp run's stream: {len(ratios)} attention and MoE "
              f"blocks, their outputs' max|d| / max|tp| up to {ratios[worst]:.3e} (block {worst}: "
              f"layer {worst // 2} {'MoE' if worst % 2 else 'attention'}), limit 0.02")
        if not max(ratios) <= 2e-2:
            fail(f"{label}: block {worst} is {ratios[worst]:.3e} from the tp run's")
        res[key] = {"free_running_ratio": free_ratio, "routing_differ": c["differ"],
                    "tokens_routed_alike": c["n_agree"], "block_ratio_max": max(ratios),
                    "block_ratios": ratios,
                    "logits_ratio": _parity(f"{label}, logits from the tp run's last stream",
                                            forced, tp_logits)}
    del params, case
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- phase 21: the observability planes --------------------------------------------

# the traceparent of request i: its trace id and the client's span id
OBS_TRACEPARENTS = [f"00-{i + 1:02x}{'ab' * 15}-{'cd' * 7}{i + 1:02x}-01" for i in range(N_REQUESTS)]
# what the kept llama3-8b weights serve in this phase: bf16, native KV pages,
# no host tier, no speculation
OBS_ENGINE = dict(quantize=None, kv_dtype="bf16", host_cache_blocks=0, num_kv_blocks=None,
                  spec_k=0)


def _get(port: int, path: str) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def _metric(text: str, name: str, **labels):
    """The sum of the samples of ``name`` whose labels include ``labels``
    in a Prometheus text exposition; None when there is none."""
    total = None
    for ln in text.splitlines():
        if ln.startswith("#"):
            continue
        head, _, value = ln.rpartition(" ")
        metric, _, lab = head.partition("{")
        if metric != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', lab))
        if all(got.get(k) == v for k, v in labels.items()):
            total = (total or 0.0) + float(value)
    return total


@contextmanager
def planes_env(**env):
    """The DYN_TPU_* knobs given (None: unset) and the process-global
    tracing, telemetry and profiling state rebuilt from them; both restored
    after."""
    from dynamo_tpu_torch.runtime import profiling, telemetry, tracing

    old = {k: os.environ.get(k) for k in env}

    def apply(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tracing.configure()
        telemetry.configure()
        profiling.reset_for_tests()

    apply(env)
    try:
        yield
    finally:
        apply(old)


@contextmanager
def obs_server(weights: dict, flags, name: str):
    """A fresh engine over the kept weights with the planes the environment
    arms, its pipelines and ``cli.run``'s HTTP server; yields (engine,
    port) and closes the engine after."""
    from dynamo_tpu_torch.cli.run import make_pipelines

    core = fresh_engine(weights["params"], weights["cfg"], weights["ecfg"], **OBS_ENGINE)
    flags.port = _free_port()
    chat, comp = make_pipelines(core_card(flags), core)
    try:
        with http_server(chat, comp, name, flags) as port:
            yield core, port
    finally:
        close_engine(core)


def obs_wave(core, port: int, bodies: list, headers=None) -> dict:
    n0 = len(core.recent_ttft_s)
    results, t_sent, wall = run_streams(port, bodies, MAX_TOKENS, headers)
    ttft, tok_s = wave_figures(results, t_sent, list(core.recent_ttft_s)[n0:])
    return {"ttft_p50_ms": ttft, "decode_tok_s": tok_s, "wall_s": wall}


def check_routes(port: int, name: str, dispatches: int) -> dict:
    """Phase 21's first check, on the server of the wave just answered."""
    from dynamo_tpu_torch.runtime import telemetry

    st, live = _get(port, "/live")
    if st != 200 or json.loads(live) != {"live": True}:
        fail(f"observability: /live answered {st} {live[:200]}")
    st, text = _get(port, "/metrics")
    req = "dynamo_frontend_requests_total"
    got = {
        "success": _metric(text, req, model=name, status="success"),
        "chat": _metric(text, req, model=name, endpoint="chat/completions", status="success"),
        "completions": _metric(text, req, model=name, endpoint="completions",
                               status="success"),
        "ttft_count": _metric(text, "dynamo_frontend_time_to_first_token_seconds_count",
                              model=name),
        "inflight": _metric(text, "dynamo_frontend_inflight_requests", model=name),
        **{f"phase_{p}": _metric(text, "dynamo_phase_latency_seconds_count", phase=p)
           for p in ("queue_wait", "prefill", "decode", "ttft", "inter_token")},
    }
    half = N_REQUESTS // 2
    want = {"success": N_REQUESTS, "chat": half, "completions": half,
            "ttft_count": N_REQUESTS, "inflight": 0, "phase_queue_wait": N_REQUESTS,
            "phase_prefill": N_REQUESTS, "phase_decode": N_REQUESTS}
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if st != 200 or bad or not got["phase_inter_token"]:
        fail(f"observability: /metrics {st}: (got, want) {bad}, inter_token {got['phase_inter_token']}")
    st, body = _get(port, "/debug/traces")
    traces = {t["trace_id"]: t for t in map(json.loads, body.splitlines())} if st == 200 else {}
    for tp in OBS_TRACEPARENTS:
        _, tid, parent, _ = tp.split("-")
        spans = {s["name"]: s for s in traces.get(tid, {}).get("spans", [])}
        edge, req_s = spans.get("http.edge"), spans.get("engine.request")
        ok = (edge is not None and req_s is not None and edge.get("parent_id") == parent
              and req_s.get("parent_id") == edge["span_id"]
              and all(spans.get(f"engine.{p}", {}).get("parent_id") == req_s["span_id"]
                      for p in ("queue_wait", "prefill", "decode"))
              and spans["engine.decode"].get("attributes", {}).get("tokens") == MAX_TOKENS)
        if not ok:
            fail(f"observability: trace {tid} in /debug/traces ({st}) is not http.edge -> "
                 f"engine.request -> queue_wait/prefill/decode with {MAX_TOKENS} tokens: "
                 f"{json.dumps(traces.get(tid))[:600]}")
    if len(traces) != N_REQUESTS:
        fail(f"observability: /debug/traces holds {len(traces)} traces, expected {N_REQUESTS}")
    st, body = _get(port, "/debug/slo")
    slo = json.loads(body) if st == 200 else {}
    rows = {(r["slo"], r["labels"].get("model")) for r in slo.get("slo", [])}
    # events in the fast window of the edge's latency series
    fast = f"{telemetry.policy().fast_window:g}s"
    series = slo.get("series", {})
    ttft_n = series.get(f"ttft_ms{{model={name}}}", {}).get(fast, {}).get("count", 0)
    itl_n = series.get(f"itl_ms{{model={name}}}", {}).get(fast, {}).get("count", 0)
    if not {("ttft_p95", name), ("itl_p95", name)} <= rows or ttft_n != N_REQUESTS or itl_n < 1:
        fail(f"observability: /debug/slo {st}: objectives {sorted(map(str, rows))}, "
             f"ttft events {ttft_n}, itl events {itl_n}")
    st, body = _get(port, "/debug/profile?trace=1")
    chrome = json.loads(body) if st == 200 else {}
    slices = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    st2, body = _get(port, "/debug/profile")
    summary = json.loads(body).get("summary", {}) if st2 == 200 else {}
    if not slices or summary.get("dispatches_total") != dispatches:
        fail(f"observability: /debug/profile?trace=1 {st} with {len(slices)} slices; summary "
             f"dispatches_total {summary.get('dispatches_total')} against the engine's "
             f"{dispatches} chunk and decode dispatches")
    return {"metrics": got, "traces": len(traces), "slo_rows": len(rows), "ttft_events": ttft_n,
            "itl_events": itl_n, "chrome_slices": len(slices), "summary": summary}


GATE_CALLS = 500  # gate launches per timing, each already released


def gate_kernel_check(card: str) -> dict:
    """The dispatch gate against its plain version (the host's verdict on
    the same flags and ticket): released, work behind it runs and equals
    the same work ungated; not released, it holds (and its plain version
    says closed) until the ticket is written. Times a released gate on the
    card (launches queued behind a sleep kernel, so the card, not the
    host, is timed) and the plain version on the host."""
    import torch

    from dynamo_tpu_torch.ops.dispatch_gate import dispatch_gate_wait, dispatch_gate_wait_plain

    dev = torch.device("cuda")
    flags = torch.zeros(2, dtype=torch.int32, pin_memory=True)
    counter = flags.numpy().view("uint32")
    gen = torch.Generator(device="cuda").manual_seed(31)
    a = torch.randn((1024, 4096), generator=gen, device=dev).bfloat16()
    w = torch.randn((4096, 4096), generator=gen, device=dev).bfloat16()
    want = a @ w
    torch.cuda.synchronize()
    if dispatch_gate_wait_plain(flags, 1):
        fail("dispatch gate: the plain version calls an unwritten ticket released")
    dispatch_gate_wait(flags, 1, dev)
    got = a @ w
    done = torch.cuda.Event()
    done.record()
    time.sleep(0.05)
    held = not done.query()
    counter[0] = 1
    done.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not held or not dispatch_gate_wait_plain(flags, 1) or err != 0.0 or flags[1].item():
        fail(f"dispatch gate: held {held}, max |gated - ungated| {err}, timeout flag "
             f"{flags[1].item()}")
    torch.cuda._sleep(100_000_000)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(GATE_CALLS):
        dispatch_gate_wait(flags, 1, dev)
    t1.record()
    t1.synchronize()
    ms = t0.elapsed_time(t1) / GATE_CALLS
    h0 = time.perf_counter()
    for _ in range(GATE_CALLS):
        dispatch_gate_wait_plain(flags, 1)
    plain_ms = (time.perf_counter() - h0) * 1e3 / GATE_CALLS
    # the bytes rule's bound (one 4-byte read at the HBM rate) means nothing
    # for a kernel that polls the host's memory; what binds it is one launch
    # and one read over PCIe: the first is timed here as a one-element fill
    # run back to back the same way
    bound_ms = 4 / hbm_rate(card) * 1e3
    one = torch.zeros(1, device=dev)
    one.fill_(1.0)  # loaded before it is queued behind the sleep
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0.record()
    for _ in range(GATE_CALLS):
        one.fill_(1.0)
    t1.record()
    t1.synchronize()
    floor_ms = t0.elapsed_time(t1) / GATE_CALLS
    print(f"dispatch gate: holds the stream until released (work behind it equal to the "
          f"ungated product, max |d| {err}); a released gate {ms * 1e3:.2f} us on the card "
          f"against a one-element fill's {floor_ms * 1e3:.2f} us run the same way (the launch "
          f"floor), its plain version {plain_ms * 1e3:.2f} us on the host; the bytes rule's "
          f"bound {bound_ms:.2e} ms (one 4-byte read at the HBM rate: not what binds a poll "
          f"of host memory)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "launch_floor_ms": floor_ms}


def phase_observability(card: str, weights: dict, flags, name: str) -> dict:
    """The JAX serving path's observability planes on the port, through
    ``cli.run``'s HTTP pipeline over fresh engines on the kept llama3-8b
    bf16 weights (32 layers, 8 slots, context 2048): (1) with the default
    planes and DYN_TPU_PROFILE=1, 8 streams each carrying its own
    traceparent, then the five routes held (:func:`check_routes`); (2) with
    every dispatch timed (DYN_TPU_PROFILE_SAMPLE=1), the engine's decode
    device time per step and its device idle fraction held against the
    profiler's over the same decode dispatches (:func:`timeline_check`:
    0.7-2x, within 0.10); (3) TTFT p50 and decode tok/s with the default
    planes against tracing and SLO telemetry off, and with
    DYN_TPU_PROFILE=1 against profiling off: printed, not held; (4) the
    timed path on int8 weights, int8 KV, the host tier and speculation
    (:func:`timed_configs_check`). The engines serve a card
    whose tokenizer decodes every id to text, so that every stream has
    content chunks for the edge's TTFT and ITL."""
    gate = gate_kernel_check(card)
    # the edge's TTFT and ITL need content chunks: a card whose tokenizer
    # decodes every id of the random model's vocabulary to text (the
    # byte-level one decodes ids past 257 to nothing)
    tmp = tempfile.TemporaryDirectory()
    served_path, flags.model_path = flags.model_path, write_model_dir(
        os.path.join(tmp.name, "llama3-8b-text-vocab"), text_vocab=True)
    try:
        return observability_checks(card, weights, flags, name, gate)
    finally:
        flags.model_path = served_path
        tmp.cleanup()


def observability_checks(card: str, weights: dict, flags, name: str, gate: dict) -> dict:
    """Phase 21's four checks (:func:`phase_observability`)."""
    from dynamo_tpu_torch.ops import dispatch_gate
    from dynamo_tpu_torch.ops.dispatch_gate import dispatch_gate_wait
    from dynamo_tpu_torch.runtime import profiling

    bodies = request_bodies(name, N_REQUESTS, MAX_TOKENS)
    headers = [{"traceparent": tp} for tp in OBS_TRACEPARENTS]
    planes = {"default planes": {"DYN_TPU_PROFILE": None},
              "trace and slo off": {"DYN_TPU_PROFILE": None, "DYN_TPU_TRACE": "0",
                                    "DYN_TPU_SLO": "0"},
              "profile on": {"DYN_TPU_PROFILE": "1", "DYN_TPU_PROFILE_SAMPLE": None}}
    # check 3's waves in turns, a fresh engine each; check 1 on the first
    # wave with DYN_TPU_PROFILE=1
    cost = {label: [] for label in planes}
    routes = None
    for label in list(planes) + list(planes)[::-1]:
        with planes_env(**planes[label]), obs_server(weights, flags, name) as (core, port):
            if label == "profile on" and routes is None:
                dispatch_gate.reset_launch_counts()
                cost[label].append(obs_wave(core, port, bodies, headers))
                gate_launches = dispatch_gate_wait.launches
                routes = check_routes(port, name, core.chunk_dispatches + core.decode_dispatches)
                sampled_total = profiling.timeline().sampled_total
                m = core.metrics_snapshot()
            else:
                cost[label].append(obs_wave(core, port, bodies))
    print(f"observability: {N_REQUESTS} traced streams (4 chat, 4 completions); /live, "
          f"/metrics {routes['metrics']}, {routes['traces']} traces http.edge -> engine.request "
          f"-> queue_wait/prefill/decode, /debug/slo {routes['slo_rows']} objective rows with "
          f"{routes['ttft_events']} TTFT and {routes['itl_events']} ITL events, "
          f"/debug/profile?trace=1 {routes['chrome_slices']} slices, dispatches_total "
          f"{routes['summary']['dispatches_total']} ({sampled_total} timed at the default "
          f"sample rate, {gate_launches} dispatch gates); snapshot gauges "
          + ", ".join(f"{k} {m[k]}" for k in ("decode_tokens_per_s", "step_time_ms",
                                              "batch_slot_util", "dispatch_device_us_p95",
                                              "dispatch_host_overhead_us_p95",
                                              "device_idle_frac", "dispatch_gate_timeouts")))
    if m["dispatch_gate_timeouts"]:
        fail(f"observability: {m['dispatch_gate_timeouts']} dispatch gates timed out")
    timeline = timeline_check(card, weights, flags, name, bodies)
    configs = timed_configs_check(weights)
    mean = {label: {k_: statistics.fmean(w[k_] for w in waves)
                    for k_ in ("ttft_p50_ms", "decode_tok_s")} for label, waves in cost.items()}
    base, quiet, profiled = (mean[k_] for k_ in planes)
    print("observability: cost of the planes (two waves each, in turns; printed, not held): "
          + "; ".join(f"{label}: TTFT p50 "
                      + ", ".join(f"{w['ttft_p50_ms']:.1f}" for w in waves) + " ms, decode "
                      + ", ".join(f"{w['decode_tok_s']:.1f}" for w in waves) + " tok/s"
                      for label, waves in cost.items())
          + f"; default planes against tracing and SLO off (means): TTFT "
          f"{base['ttft_p50_ms'] / quiet['ttft_p50_ms'] - 1:+.1%}, tok/s "
          f"{base['decode_tok_s'] / quiet['decode_tok_s'] - 1:+.1%}; DYN_TPU_PROFILE=1 against "
          f"off: TTFT {profiled['ttft_p50_ms'] / base['ttft_p50_ms'] - 1:+.1%}, tok/s "
          f"{profiled['decode_tok_s'] / base['decode_tok_s'] - 1:+.1%}")
    return {"routes": routes, "cost": cost, "gate_launches": gate_launches, "gate": gate,
            "timeline": timeline, "timed_configs": configs}


TIMELINE_DISPATCHES = 6  # decode dispatches in check 2's profiler window, at least


def timeline_check(card: str, weights: dict, flags, name: str, bodies: list) -> dict:
    """Phase 21's second check. Every dispatch timed (DYN_TPU_PROFILE_SAMPLE=1)
    under :func:`profile_decode`'s torch.profiler window, started and
    stopped with the engine's device timing paused
    (``pause_device_timing``), so that every decode dispatch the trace holds
    whole was timed or not as a whole. The engine's decode records are
    matched one to one with those dispatches (the k-th timed dispatch made
    the k-th record), and both sides are read over the same dispatches,
    found in the trace by their gates (:func:`dispatch_device_times`): the
    engine's device time per step
    against the profiler's (the union of the dispatch's device events,
    held 0.7-2x) and against the sum of the profiler's gated segments (what
    the engine's event pairs time: printed, with the gaps between kernels
    as a share of it), and the engine's device_idle_frac against the
    profiler's idle share from the first dispatch's start to the last one's
    (held within 0.10); at least 4 matched dispatches, each with all its
    gates in the trace."""
    from dynamo_tpu_torch.runtime import profiling
    from dynamo_tpu_torch.runtime.profiling import StepTimeline

    with planes_env(DYN_TPU_PROFILE="1", DYN_TPU_PROFILE_SAMPLE="1"), obs_server(
            weights, flags, name) as (core, port):
        n0 = sum(r["phase"] == "decode" for r in profiling.timeline().records())
        prof = profile_decode(port, bodies, core, core.pause_device_timing,
                              TIMELINE_DISPATCHES, dispatch_device_times)
        k = core.config.decode_steps
        every = [r for r in profiling.timeline().records()
                 if r["phase"] in ("chunk", "decode", "verify")]
        recs = [r for r in every if r["phase"] == "decode"][n0:]
        timeouts = core.metrics_snapshot()["dispatch_gate_timeouts"]
    traced = prof["trace"]
    if timeouts or traced is None:
        fail(f"observability: {timeouts} gate timeouts; trace read {traced is not None}")
    # the wave's decode dispatches after profile_decode unwraps the step
    # functions make records of their own, after the wrapped ones
    timed = traced["timed_calls"]
    if len(recs) < len(timed):
        fail(f"observability: {len(timed)} timed decode dispatches but {len(recs)} decode "
             f"records")
    by_n = dict(zip(timed, recs))
    disp = traced["dispatches"]
    pairs = [(d, by_n[d["n"]]) for d in disp]
    if len(pairs) < 4:
        fail(f"observability: {len(pairs)} timed decode dispatches held whole by the trace "
             f"(at least 4 needed); {traced['gates_in_trace']} gates in the trace, "
             f"{traced['gates_launched']} launched while it ran; {traced['window_calls']} timed "
             f"decode dispatches launched then; gates per dispatch in the trace "
             f"{traced['trace_dispatches']}")
    steps = len(pairs) * k
    eng_ms = sum(r["device_us"] for _, r in pairs) / 1e3 / steps
    prof_ms = sum(d["busy_us"] for d, _ in pairs) / 1e3 / steps
    span_ms = sum(d["span_us"] for d, _ in pairs) / 1e3 / steps
    gap_share = 1.0 - sum(d["kernel_sum_us"] for d, _ in pairs) / sum(d["span_us"]
                                                                      for d, _ in pairs)
    ratio = eng_ms / prof_ms
    # every record from the first matched dispatch's to the last one's, a
    # chunk between them included, as the profiler's busy time includes it
    t_lo, t_hi = pairs[0][1]["ts"], pairs[-1][1]["ts"]
    eng_idle = StepTimeline.device_idle_frac([r for r in every if t_lo <= r["ts"] <= t_hi])
    prof_idle = traced["idle_share"]
    per = ", ".join(f"{r['device_us'] / 1e3:.3f}/{d['busy_us'] / 1e3:.3f}/{d['span_us'] / 1e3:.3f}"
                    f" ({d['gates']} gates)" for d, r in pairs)
    print(f"observability: timeline against the profiler over the same {len(pairs)} decode "
          f"dispatches ({steps} steps, every dispatch timed, each with all its gates in the "
          f"trace; {traced['gates_in_trace']} gates in the trace of "
          f"{traced['gates_launched']} launched while it ran, {traced['window_calls']} timed "
          f"decode dispatches): engine device {eng_ms:.3f} ms per step against the "
          f"profiler's {prof_ms:.3f} (ratio {ratio:.3f}, held 0.7-2) and its gated segments' "
          f"{span_ms:.3f} (engine / segments {eng_ms / span_ms:.3f}); gaps between kernels "
          f"{gap_share:.3f} of the segments; engine device_idle_frac {eng_idle:.4f} against "
          f"the profiler's idle share {prof_idle:.4f} over the same span (held within 0.10); "
          f"per dispatch engine/profiler/segments ms {per}; host_us per decode dispatch "
          f"{statistics.median(r['host_us'] for _, r in pairs) / 1e3:.1f} ms (median); the "
          f"profile window's own figures {prof.get('device_ms_per_step', float('nan')):.3f} ms "
          f"per step, idle {prof.get('idle_share', float('nan')):.4f}; on {card}")
    if not 0.7 <= ratio <= 2.0 or abs(eng_idle - prof_idle) > 0.10:
        fail(f"observability: engine device {eng_ms:.3f} ms/step, idle {eng_idle:.4f} against "
             f"the profiler's {prof_ms:.3f}, {prof_idle:.4f} over the same dispatches")
    return {"engine_device_ms_per_step": eng_ms, "engine_idle_frac": eng_idle,
            "profiler_device_ms_per_step": prof_ms, "profiler_segments_ms_per_step": span_ms,
            "gap_share": gap_share, "profiler_idle_share": prof_idle, "ratio": ratio,
            "decode_dispatches": len(pairs),
            "per_dispatch_ms": [(r["device_us"] / 1e3, d["busy_us"] / 1e3, d["span_us"] / 1e3)
                                for d, r in pairs]}


def timed_configs_check(weights: dict) -> dict:
    """Phase 21's fourth check: the timed path on the configurations check
    2 does not run. One engine on the kept weights with ``quantize="int8"``,
    int8 KV pages, the host tier and ``spec_k`` = SPEC_K, every dispatch
    timed: three waves straight into ``core.generate`` (prompts that repeat
    a phrase; others that evict their cached blocks to the host tier; the
    first again). Holds: no gate timed out, timed chunk and verify
    dispatches (decode ones printed: with speculation on there are few),
    drafted tokens and host-tier hits."""
    import numpy as np

    from dynamo_tpu_torch.runtime import profiling

    params, cfg, ecfg = weights["params"], weights["cfg"], weights["ecfg"]
    rng = np.random.default_rng(21)
    first, other = repeating_prompts(rng, cfg.vocab_size), repeating_prompts(rng, cfg.vocab_size)
    bs, k = ecfg.kv_block_size, ecfg.decode_steps
    blocks = max(sum(-(-(len(p) + MAX_TOKENS + 2 * k + SPEC_K + 1) // bs) + 1 for p in wave)
                 for wave in (first, other)) + 16
    t0 = time.perf_counter()
    with planes_env(DYN_TPU_PROFILE="1", DYN_TPU_PROFILE_SAMPLE="1"):
        core = fresh_engine(params, cfg, ecfg, quantize="int8", kv_dtype="int8", spec_k=SPEC_K,
                            num_kv_blocks=blocks, host_cache_blocks=4 * blocks)
        try:
            for i, prompts in enumerate((first, other, first)):
                engine_wave(core, prompts, MAX_TOKENS)
                if i == 1:  # the spills reach the host pool between waves
                    deadline = time.perf_counter() + 30
                    while not len(core.host_pool) and time.perf_counter() < deadline:
                        time.sleep(0.01)
            recs = profiling.timeline().records()
            m = core.metrics_snapshot()
        finally:
            close_engine(core)
    by = {p: [r["device_us"] / 1e3 for r in recs if r["phase"] == p]
          for p in ("chunk", "decode", "verify")}
    print(f"observability: int8 weights, int8 KV, host tier of {4 * blocks} blocks, spec_k "
          f"{SPEC_K}, every dispatch timed, three waves in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{p} {len(v)} timed (device ms median "
                      f"{statistics.median(v) if v else float('nan'):.3f})" for p, v in by.items())
          + f" of {m['chunk_dispatches']} chunk, "
          f"{m['decode_dispatches']} decode and {m['verify_dispatches']} verify dispatches; "
          f"{m['dispatch_gate_timeouts']} gate timeouts, drafted {m['spec_drafted_tokens']}, "
          f"host-tier hits {m['host_cache_hits']}")
    if (m["dispatch_gate_timeouts"] or not by["chunk"] or not by["verify"]
            or min(by["chunk"] + by["verify"] + by["decode"]) <= 0
            or m["spec_drafted_tokens"] <= 0 or m["host_cache_hits"] <= 0):
        fail("observability: the timed path on int8 weights, int8 KV, the host tier and "
             "speculation did not hold (the line above)")
    return {"timed": {p: len(v) for p, v in by.items()},
            "device_ms_median": {p: statistics.median(v) if v else None for p, v in by.items()},
            "gate_timeouts": m["dispatch_gate_timeouts"], "drafted": m["spec_drafted_tokens"],
            "host_cache_hits": m["host_cache_hits"]}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "dynamo_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(dynamo_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = {}

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        print(f"phase {label}: {seconds[label]:.1f} s")
        return out

    card = timed("device", phase_device)
    print(f"profiler: first start and stop in {warm_profiler():.1f} s")
    timed("build", phase_build)
    kern = timed("kernels", phase_kernels, card)
    tpk = timed("kernels tp", phase_tp_kernels, card)
    kv8k = timed("kernels int8 KV", phase_kv_int8_kernel, card)
    int8k = timed("int8 kernel", phase_int8_kernel, card)
    expk = timed("expert kernel", phase_expert_kernel, card)
    with tempfile.TemporaryDirectory() as tmp:
        loaded = timed("load", phase_load, card, os.path.join(tmp, "llama3-8b-2-layers"))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        served = timed("serve", phase_serve, card,
                       write_model_dir(os.path.join(tmp, "llama3-8b-random")))
        parity = timed("parity", phase_parity, served["core"])
        int8s = timed("int8 serve", phase_int8_serve, card, served)
        int8p = timed("int8 parity", phase_int8_parity, int8s["core"])
        int8_core = int8s.pop("core")
        int8_core.close()
        # the model directory is still there: phase 11 reads its card
        kvs = timed("kv int8 serve", phase_kv_int8_serve, card, int8_core, served["flags"],
                    served["name"])
        del int8_core
    weights = kvs.pop("weights")
    integ = timed("integrity", phase_integrity, card, weights)
    spec = timed("spec serve", phase_spec_serve, card, weights, int8k["per_verify"])
    tps = timed("tp serve", phase_tp_serve, card, weights, served)
    obs = timed("observability", phase_observability, card, weights, served["flags"],
                served["name"])
    del weights
    tp70 = timed("tp 70b", phase_tp_70b, card)
    # every llama engine is closed: free the card for mixtral's 47 GB
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"llama engines closed: {left / 1e9:.3f} GB still allocated on the card")
    if left > 1e9:
        fail(f"{left / 1e9:.2f} GB still allocated after the llama phases")
    with tempfile.TemporaryDirectory() as tmp:
        mixl = timed("mixtral load", phase_mixtral_load, card,
                     os.path.join(tmp, "mixtral-8x7b-1-layer"))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mixs = timed("mixtral serve", phase_mixtral_serve, card,
                     os.path.join(tmp, "mixtral-8x7b-random"))
    mix_core = mixs.pop("core")
    mix_core.close()
    mix_params, mix_cfg = mix_core.params, mix_core.model_config
    del mix_core
    gc.collect()
    torch.cuda.empty_cache()
    mixp = timed("mixtral parity", phase_mixtral_parity, mix_params, mix_cfg)
    del mix_params
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"mixtral engines closed: {left / 1e9:.3f} GB still allocated on the card")
    if left > 1e9:
        fail(f"{left / 1e9:.2f} GB still allocated after the mixtral phases")
    l70 = timed("llama3-70b", phase_llama70b, card)
    mixtp = timed("mixtral tp", phase_mixtral_tp, card)
    main_regime = kern[REGIMES[0][0]]
    tp_regime = tpk[TP_REGIMES[0][0]]
    kv8_regime = kv8k[REGIMES[0][0]]
    step, estep, echunk = int8k["per_step"], expk["per_step"], expk["prefill_chunk"]
    decode_cases = [c for c in int8k["cases"] if c["M"] in (1, 8) and c["x"] == "bf16"]
    (chunk_case,) = [c for c in int8k["cases"]
                     if c["M"] == 1024 and c["name"].startswith(INT8_PREFILL[0])]
    line = {"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas/paged_attention.py:554 (v4; also v2 :258, v1 :693)",
        "launches": served["launches"],
        "max_abs_err": main_regime["max_abs_err"],
        "ms": main_regime["ms"],
        "plain_ms": main_regime["plain_ms"],
        "bound_ms": main_regime["bound_ms"],
        "bound_by": main_regime["bound_by"],
        "library_ms": main_regime["library_ms"],
        "bound_share": main_regime["bound_share"],
        # both kernels' launches on the main path, as the wrapper counted them
        "device_launches": served["kernel_launches"],
        "device_launches_per_call": served["device_launches_per_call"],
        "splits": served["splits"],
        "launches_int8_serve": int8s["launches"],
        "launches_mixtral_serve": mixs["launches"],
        "launches_llama70b_serve": l70["launches"],
        "regimes": [dict(name=k, **v) for k, v in kern.items()],
    }, {
        "name": "paged_decode_attention_sharded",
        "wrapper": "dynamo_tpu_torch/ops/paged_attention.py",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas/paged_attention.py:626 (shard_map over tp running "
                    "v2 :258 or v1 :693 on each rank's head shard)",
        # phase 16's served wave: one call per layer and decode step
        "launches": tps["serve"]["sharded_launches"],
        "unit": f"all {TP_REGIMES[0][3]} ranks of one layer (one call), {TP_REGIMES[0][0]}, "
                f"8 lanes x 2048",
        "max_abs_err": tp_regime["max_abs_err"],
        "ms": tp_regime["ms"],
        "graph_ms": tp_regime["graph_ms"],
        "plain_ms": tp_regime["plain_ms"],
        "bound_ms": tp_regime["bound_ms"],
        "bound_by": tp_regime["bound_by"],
        "library_ms": tp_regime["library_ms"],
        "bound_share": tp_regime["bound_share"],
        "launches_tp_70b": tp70["sharded_launches"],
        "launches_int8_all_tp": tps["int8_all"]["sharded_launches"],
        "launches_mixtral_tp": mixtp["sharded_launches"],
        "per_rank_launches": tps["serve"]["launches"],
        "device_launches": tps["serve"]["kernel_launches"],
        "regimes": [dict(name=k, **v) for k, v in tpk.items()],
    }, {
        "name": "paged_decode_attention_int8",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
        "replaces": "none — XLA `dequantize_kv` + `gather_history` dense tier, "
                    "`dynamo_tpu/models/llama.py:246, 534`",
        "launches": kvs["launches"],
        "max_abs_err": kv8_regime["max_abs_err"],
        "ms": kv8_regime["ms"],
        "graph_ms": kv8_regime["graph_ms"],
        "plain_ms": kv8_regime["plain_ms"],
        "bound_ms": kv8_regime["bound_ms"],
        "bound_by": kv8_regime["bound_by"],
        "library_ms": None,
        "bound_share": kv8_regime["bound_share"],
        "fp64_rms_err": kv8_regime["fp64_rms_err"],
        "fp64_rms_err_bf16_kernel_dequantized": kv8_regime["fp64_rms_err_bf16_kernel_dequantized"],
        "bf16_kernel_ms": kv8_regime["bf16_kernel_ms"],
        "bf16_kernel_graph_ms": kv8_regime["bf16_kernel_graph_ms"],
        "dequant_then_bf16_ms": kv8_regime["dequant_then_bf16_ms"],
        "device_launches": kvs["device_launches"],
        "decode_steps": kvs["decode_steps"],
        "regimes": [dict(name=k, **v) for k, v in kv8k.items()],
    }, {
        "name": "int8_weight_matmul",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "dynamo_tpu/models/llama.py:255 (matw, and lm_head :456: XLA's fused "
                    "int8 convert-dot, no Pallas kernel)",
        "launches": int8s["int8_launches"],
        "launches_mixtral_serve": mixs["int8_launches"],
        "launches_llama70b_serve": l70["int8_launches"],
        "launches_int8_all_tp": tps["int8_all"]["int8_launches"],
        "launches_mixtral_tp": mixtp["int8_launches"],
        # the sums of phase 4's new shapes: llama3-70b's 561 products and one
        # tp=2 rank's 225 at llama3-8b widths, per decode step and chunk
        "llama70b_decode_step": int8k["step_70b"],
        "llama70b_prefill_chunk": int8k["chunk_70b"],
        "tp2_rank_decode_step": int8k["step_tp2"],
        "tp2_rank_prefill_chunk": int8k["chunk_tp2"],
        # one decode step at M = 8: the 225 launches over the five shapes
        "unit": f"one decode step, M=8, {INT8_LAUNCHES_PER_STEP} launches",
        "max_abs_err": max(c["max_abs_err"] for c in decode_cases),
        "ms": step["ms"],
        "graph_ms": step["graph_ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": "bytes",
        "library_ms": step["library_ms"],
        "library_graph_ms": step["library_graph_ms"],
        "bound_share": step["bound_share"],
        "launches_per_decode_step": INT8_LAUNCHES_PER_STEP,
        "decode_steps": int8s["decode_steps"],
        # one speculative verify dispatch at M = 40: its plans and the five
        # shapes' times summed; the launches of phase 13's int8 spec-on
        # wave (verify dispatches and decode steps)
        "verify_dispatch": dict(int8k["per_verify"], plans=spec.get("verify_plans"),
                                spec_wave_launches=spec["int8"]["int8_launches"],
                                spec_wave_device_launches=spec["int8"]["int8_kernels"]),
        # each kernel's launches: decode (phase 8) and the int8-all chunk (phase 9)
        "device_launches": int8s["int8_kernel_launches"],
        "device_launches_int8_all_chunk": int8p["chunk_launches"],
        "prefill_chunk": chunk_case,
        "cases": int8k["cases"],
        "kernel_sweep": int8k["sweep"],
    }, {
        "name": "int8_expert_matmul",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "dynamo_tpu/ops/moe.py:70 (_expert_mat: XLA's fused int8 convert-einsum "
                    "over the expert stack, no Pallas kernel)",
        "launches": mixs["expert_launches"],
        "launches_mixtral_tp": mixtp["expert_launches"],
        # one tp=2 rank's 96 stacks at F/2, per decode step and chunk
        "tp2_rank_decode_step": expk["step_tp2"],
        "tp2_rank_prefill_chunk": expk["chunk_tp2"],
        # one mixtral decode step at C = 4: the 96 launches over the two shapes
        "unit": f"one mixtral-8x7b decode step, 8 experts, C=4, {EXPERT_LAUNCHES_PER_STEP} "
                f"launches",
        "max_abs_err": max(c["max_abs_err"] for c in expk["cases"] if c["C"] == 4),
        "ms": estep["ms"],
        "graph_ms": estep["graph_ms"],
        "plain_ms": estep["plain_ms"],
        "bound_ms": estep["bound_ms"],
        "bound_by": "bytes",
        "library_ms": estep["library_ms"],
        "library_graph_ms": estep["library_graph_ms"],
        "bound_share": estep["bound_share"],
        "launches_per_decode_step": EXPERT_LAUNCHES_PER_STEP,
        "decode_steps": mixs["decode_steps"],
        "chunk_dispatches": mixs["chunk_dispatches"],
        "device_launches_int8_both_wrappers": mixs["int8_kernel_launches"],
        "cases": expk["cases"],
    }, {
        "name": "w8a16_expert_tile_kernel",
        "wrapper": "int8_expert_matmul",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "dynamo_tpu/ops/moe.py:70 (_expert_mat on a prefill chunk's expert stacks: "
                    "XLA's fused int8 convert-einsum, no Pallas kernel)",
        "launches": mixs["int8_kernel_launches"].get("w8a16_expert_tile_kernel", 0),
        "launches_mixtral_tp": mixtp["int8_kernel_launches"].get("w8a16_expert_tile_kernel", 0),
        # the expert products of one 1024-row prefill chunk: 96 stacks at C = 512
        "unit": f"the expert products of one 1024-row mixtral-8x7b prefill chunk, 8 experts, "
                f"C=512, {EXPERT_LAUNCHES_PER_STEP} launches",
        "max_abs_err": max(c["expert_tile_max_abs_err"] for c in expk["cases"]),
        "ms": echunk["ms"],
        "graph_ms": echunk["graph_ms"],
        "plain_ms": echunk["plain_ms"],
        "bound_ms": echunk["bound_ms"],
        "bound_by": "operations",
        "library_ms": echunk["library_ms"],
        "library_graph_ms": echunk["library_graph_ms"],
        "bound_share": echunk["bound_share"],
        "tile_kernel_graph_ms": echunk["tile_graph_ms"],
        "chunk_dispatches": mixs["chunk_dispatches"],
        "kernel_sweep": expk["sweep"],
    }, {
        "name": "dispatch_gate_wait",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/dispatch_gate.cu",
        "replaces": "none — the profiling plane's device timing: jax.block_until_ready around "
                    "a sampled dispatch, dynamo_tpu/engine_jax/engine.py:2537",
        # phase 21's wave with DYN_TPU_PROFILE=1 at the default sample rate
        "launches": obs["gate_launches"],
        "unit": "one released gate (a 4-byte read of the host's counter)",
        "max_abs_err": obs["gate"]["max_abs_err"],
        "ms": obs["gate"]["ms"],
        "plain_ms": obs["gate"]["plain_ms"],
        "bound_ms": obs["gate"]["bound_ms"],
        "bound_by": "bytes",
        # what does bind a released gate: one launch (timed as a one-element
        # fill run back to back) and one read of host memory over PCIe
        "launch_floor_ms": obs["gate"]["launch_floor_ms"],
        "library_ms": None,
    }], "serve": {"ttft_p50_ms": served["ttft_p50_ms"], "decode_tok_s": served["decode_tok_s"],
                  "profile": served["profile"], "parity_ratio": parity},
        "int8_serve": {"ttft_p50_ms": int8s["ttft_p50_ms"], "decode_tok_s": int8s["decode_tok_s"],
                       "profile": int8s["profile"], **int8p},
        "kv_int8_serve": kvs, "integrity": integ, "spec_serve": spec,
        "mixtral_serve": {k: mixs[k] for k in (
            "ttft_p50_ms", "decode_tok_s", "profile", "peak_gb", "weights_gb", "kv_gb", "build_s",
            "warmup_s", "decode_steps", "chunk_dispatches", "launches", "int8_launches",
            "expert_launches", "int8_kernel_launches")},
        "mixtral_parity": mixp, "mixtral_load": mixl, "tp_serve": tps, "tp_70b": tp70,
        "llama3_70b": l70, "mixtral_tp": mixtp, "observability": obs,
        "load": loaded, "phase_seconds": seconds,
        "card": card, "seconds": time.perf_counter() - t0}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
