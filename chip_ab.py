#!/usr/bin/env python3
"""Time the paged decode kernel of several checkouts in turns, on one card.

    python3 chip_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
For each ROOT in the order given, a fresh process imports that checkout's
``dynamo_tpu_torch``, builds its kernel into the checkout's own ``build/``,
and times ``paged_decode_attention`` in every regime of ``chip_smoke.py``
(bf16, the wrapper's own split plan) the way ``chip_smoke.py`` times it:
runs of many calls between one event pair, cycling through input sets whose
live K/V exceeds L2, and the same run replayed from a CUDA graph. Give the
roots as A B B A to see the spread between turns. Prints one line per run
and regime, then one JSON line with every number.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from dynamo_tpu_torch.ops.paged_attention import paged_decode_attention

    # this checkout's chip_smoke.py (regimes, inputs, timing), not the root's
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    card = cs.phase_device()
    rate = cs.hbm_rate(card)
    out = {"root": root, "card": card, "regimes": {}}
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
    if len(argv) >= 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        if not os.path.isdir(os.path.join(root, "dynamo_tpu_torch")):
            print(f"chip_ab: {root} holds no dynamo_tpu_torch/", file=sys.stderr)
            return 2
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            print(f"chip_ab: the run of {root} failed ({res.returncode})", file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(run)
        for name, r in run["regimes"].items():
            print(f"{root}: [{name}] kernel {r['ms']:.4f} ms, graph-replayed "
                  f"{r['graph_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({run['card']})",
                  flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
