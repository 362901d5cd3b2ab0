#!/usr/bin/env python3
"""Time the kernels of several checkouts in turns, on one card.

    python3 chip_ab.py [--kernels paged,kv8,int8,experts,writekv] ROOT [ROOT ...]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
For each ROOT in the order given, a fresh process imports that checkout's
``dynamo_tpu_torch``, builds its kernels into the checkout's own ``build/``,
and times them the way ``chip_smoke.py`` does: runs of many calls between
one event pair, cycling through inputs larger than L2, and the same run
replayed from a CUDA graph.

- ``paged``: ``paged_decode_attention`` in every regime of
  ``chip_smoke.py`` (bf16, the wrapper's own split plan);
- ``int8``: ``int8_weight_matmul`` at each llama3-8b shape of
  ``chip_smoke.py``'s phase 4 at M = 1, 8, 40 (a speculative verify
  dispatch of 8 lanes x 5 positions) and 1024 (bf16 activations, the
  wrapper's own plan), and each M's 225 products of one forward summed;
  then llama3-70b's shapes at M = 8 and 1024 and their 561 products of a
  decode step and of a prefill chunk summed;
- ``experts``: ``int8_expert_matmul`` over 8 experts at mixtral-8x7b's two
  expert shapes of phase 5 at C = 4 (decode), 130 and 512 (prefill), cycling
  through two stacks (bf16 activations, the wrapper's own plan);
- ``kv8``: ``paged_decode_attention_int8`` in every int8-KV regime of
  ``chip_smoke.py``'s phase 3 (bf16 compute, the wrapper's own split plan;
  a checkout without the int8-KV kernel cannot run it).

- ``writekv``: ``ops/attention.py write_kv_to_pages`` (the paged KV
  scatter every layer of a prefill chunk and of a decode window's flush
  runs) at the llama3-8b serving shapes: a chunk of 8 lanes x 128 rows, a
  quarter of them padding, and a window flush of 8 lanes x 4 rows, into a
  bf16 pool of 1536 blocks of 16. Per call: the wall time of calls run
  back to back (host clock, one synchronize at the end), and from
  torch.profiler the device events launched and the device busy time.

``paged`` and ``int8`` by default. Give the roots as A B B A to see the spread between turns.
Prints one line per run and case, then one JSON line with every number.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


INT8_M = (1, 8, 40, 1024)
EXPERT_C = (4, 130, 512)


# write_kv_to_pages cases: (name, lanes, rows per lane, padding share)
WRITE_KV_CASES = (("prefill chunk, 8 x 128, a quarter padding", 8, 128, 0.25),
                  ("window flush, 8 x 4", 8, 4, 0.0))
WRITE_KV_CALLS = 200


def write_kv_runs(torch, rate: float) -> dict:
    """``write_kv_to_pages`` of the checkout being run (:data:`WRITE_KV_CASES`)."""
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.ops.attention import write_kv_to_pages

    gen = torch.Generator(device="cuda").manual_seed(5)
    blocks, bs, kvh, d = 1536, 16, 8, 128
    k_cache = torch.zeros((blocks, bs, kvh, d), device="cuda", dtype=torch.bfloat16)
    v_cache = torch.zeros_like(k_cache)
    out = {}
    for name, lanes, rows, pad in WRITE_KV_CASES:
        mb = 128  # a 2048-token context's blocks per lane
        tables = torch.randperm(blocks, generator=gen, device="cuda")[:lanes * mb]
        tables = tables.reshape(lanes, mb).to(torch.int32)
        start = torch.randint(0, 2048 - rows, (lanes, 1), generator=gen, device="cuda")
        pos = start + torch.arange(rows, device="cuda")[None, :]
        live = int(rows * (1 - pad))
        pos[:, live:] = -1
        k = torch.randn((lanes, rows, kvh, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((lanes, rows, kvh, d), generator=gen, device="cuda").bfloat16()

        def call():
            write_kv_to_pages(k_cache, v_cache, k, v, pos, tables)

        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WRITE_KV_CALLS):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / WRITE_KV_CALLS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(WRITE_KV_CALLS):
                call()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy, end = 0.0, -1.0
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in evs):
            if b > end:
                busy += b - max(a, end)
                end = b
        # bytes: the new rows read, the written rows written (K and V), the
        # positions and the tables read
        nbytes = 2 * 2 * lanes * rows * kvh * d + 2 * 2 * lanes * live * kvh * d \
            + pos.numel() * 8 + tables.numel() * 4
        out[f"writekv {name}"] = {"ms": wall_ms, "graph_ms": None,
                                  "bound_ms": nbytes / rate * 1e3,
                                  "device_events": len(evs) / WRITE_KV_CALLS,
                                  "device_ms": busy / 1e3 / WRITE_KV_CALLS}
    return out


def worker(root: str, kernels: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from dynamo_tpu_torch.ops.int8_matmul import int8_expert_matmul, int8_weight_matmul
    from dynamo_tpu_torch.ops.paged_attention import paged_decode_attention

    # this checkout's chip_smoke.py (regimes, inputs, timing), not the root's
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    card = cs.phase_device()
    rate = cs.hbm_rate(card)
    out = {"root": root, "card": card, "regimes": {}}
    if "int8" in kernels:
        gen = torch.Generator(device="cuda").manual_seed(8)
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
        for model, shapes, ms_ in (("llama3-8b", cs.INT8_SHAPES, INT8_M),
                                   ("llama3-70b", cs.INT8_70B_SHAPES, (8, 1024))):
            forward = {M: {"ms": 0.0, "graph_ms": 0.0, "bound_ms": 0.0} for M in ms_}
            for name, K, N, o, count in shapes:
                for M in ms_:
                    x, qs, ss = cs.int8_inputs(torch, gen, K, N, M, torch.bfloat16)
                    ms, graph_ms = cs.time_int8(torch, int8_weight_matmul, x, qs, ss, dt[o])
                    b_ms = cs.int8_bound(M, N, K, 4 if o == "fp32" else 2, rate)[0]
                    out["regimes"][f"int8 {name}, M={M}"] = {"ms": ms, "graph_ms": graph_ms,
                                                             "bound_ms": b_ms}
                    for key, t in (("ms", ms), ("graph_ms", graph_ms), ("bound_ms", b_ms)):
                        forward[M][key] += count * t
                    del x, qs, ss
                    torch.cuda.empty_cache()
            n = sum(count for *_, count in shapes)
            for M, r in forward.items():
                out["regimes"][f"int8 one {model} forward's {n} products, M={M}"] = r
    if "experts" in kernels:
        gen = torch.Generator(device="cuda").manual_seed(11)
        X = cs.MIXTRAL["experts"]
        for name, K, N, _ in cs.EXPERT_SHAPES:
            qs = [torch.randint(-127, 128, (X, N, K), generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2)]
            ss = [torch.rand((X, N), generator=gen, device="cuda") * 2e-3 + 1e-4
                  for _ in range(2)]
            for C in EXPERT_C:
                x = torch.randn((X, C, K), generator=gen, device="cuda").bfloat16()
                fns = [lambda q=q, s_=s_: int8_expert_matmul(x, q, s_) for q, s_ in zip(qs, ss)]
                ms, graph_ms = cs.time_many(torch, fns), cs.time_graph(torch, fns)
                out["regimes"][f"experts {name}, X={X}, C={C}"] = {
                    "ms": ms, "graph_ms": graph_ms,
                    "bound_ms": cs.expert_bound(X, C, N, K, rate)[0]}
                del x, fns
            del qs, ss
            torch.cuda.empty_cache()
    if "kv8" in kernels:
        from dynamo_tpu_torch.ops.paged_attention import paged_decode_attention_int8

        for ri, (name, S, H, KVH, D, bs, max_len) in enumerate(cs.KV_INT8_REGIMES):
            case8 = cs.int8_pool(torch, cs.make_case(torch, S, H, KVH, D, bs, max_len,
                                                     torch.bfloat16, 300 + ri))
            lens = case8[6].cpu().numpy()
            live_kv = 2 * int(lens.sum()) * KVH * D
            n_sets = min(cs.MAX_SETS, max(4, -(-int(cs.COLD_BYTES) // live_kv)))
            sets = cs.int8_timing_sets(torch, case8, n_sets, 2000 + ri)
            fns = [lambda a=a: paged_decode_attention_int8(*a) for a in sets]
            out["regimes"][f"int8 KV {name}"] = {
                "ms": cs.time_many(torch, fns), "graph_ms": cs.time_graph(torch, fns),
                "bound_ms": cs.int8_kv_bound(S, H, KVH, D, bs, lens, rate)[0]}
            del case8, sets, fns
            torch.cuda.empty_cache()
    if "writekv" in kernels:
        out["regimes"].update(write_kv_runs(torch, rate))
    if "paged" not in kernels:
        return out
    for ri, (name, S, H, KVH, D, bs, max_len) in enumerate(cs.REGIMES):
        case = cs.make_case(torch, S, H, KVH, D, bs, max_len, torch.bfloat16, 100 + ri)
        lens = case[4].cpu().numpy()
        live_kv = 2 * int(lens.sum()) * KVH * D * 2
        n_sets = min(cs.MAX_SETS, max(4, -(-int(cs.COLD_BYTES) // live_kv)))
        sets = cs.timing_sets(torch, case, n_sets, 1000 + ri)
        fns = [lambda a=a: paged_decode_attention(*a) for a in sets]
        ms = cs.time_many(torch, fns)
        graph_ms = cs.time_graph(torch, fns)
        b_ms = cs.bound(S, H, KVH, D, bs, lens, 2, rate)[0]
        out["regimes"][name] = {"ms": ms, "graph_ms": graph_ms, "bound_ms": b_ms}
        del sets, fns
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1], argv[2])))
        return 0
    kernels = "paged,int8"
    if len(argv) >= 2 and argv[0] == "--kernels":
        kernels, argv = argv[1], argv[2:]
    if not argv or not set(kernels.split(",")) <= {"paged", "kv8", "int8", "experts",
                                                      "writekv"}:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        if not os.path.isdir(os.path.join(root, "dynamo_tpu_torch")):
            print(f"chip_ab: {root} holds no dynamo_tpu_torch/", file=sys.stderr)
            return 2
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                              kernels], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            print(f"chip_ab: the run of {root} failed ({res.returncode})", file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(run)
        for name, r in run["regimes"].items():
            if r["graph_ms"] is None:
                print(f"{root}: [{name}] wall {r['ms']:.4f} ms per call back to back, "
                      f"{r['device_events']:.1f} device events and {r['device_ms']:.4f} ms "
                      f"device busy per call, bound {r['bound_ms']:.4f} ms ({run['card']})",
                      flush=True)
                continue
            print(f"{root}: [{name}] kernel {r['ms']:.4f} ms, graph-replayed "
                  f"{r['graph_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({run['card']})",
                  flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
