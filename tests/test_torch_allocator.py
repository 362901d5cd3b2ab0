"""The port's block allocator against the JAX package's, op for op: the same
sequence of allocations, prefix hits, in-flight joins, growth, seals,
evictions and host-tier hits gives equal block ids, cached-token counts and
KV events."""

from dynamo_tpu.engine_jax import allocator as jax_alloc
from dynamo_tpu_torch.engine_torch import allocator as port_alloc


class _Sink:
    def __init__(self):
        self.events = []

    def blocks_stored(self, parent_hash, blocks):
        self.events.append(("stored", parent_hash, [(h, list(t)) for h, t in blocks]))

    def blocks_removed(self, block_hashes):
        self.events.append(("removed", list(block_hashes)))


def _run(mod):
    sink = _Sink()
    host = mod.HostKvPool(4)

    def offload(pairs):
        for h, bid, crc in pairs:
            host.put(h, ("k", bid), ("v", bid), crc=crc)

    a = mod.BlockAllocator(12, 4, event_sink=sink, host_pool=host, offload=offload)
    trace = []

    def note(x):
        if isinstance(x, mod.InflightPrefix):
            trace.append(("inflight", x.seq_hash))
        elif x is None:
            trace.append(None)
        else:
            trace.append((list(x.block_ids), x.cached_tokens, x.sealed_blocks,
                          [(i, h) for i, h, *_ in x.host_hits]))
        return x

    p1 = list(range(1, 14))  # 13 tokens: 3 full blocks + 1
    s1 = note(a.allocate_sequence(p1))
    note(a.allocate_sequence(p1 + [99]))  # same prefix mid-prefill: joins
    a.note_tokens_computed(s1, p1)
    assert a.grow(s1, 18)
    a.note_tokens_computed(s1, [50, 51, 52, 53])
    trace.append(list(s1.block_ids))
    s2 = note(a.allocate_sequence(p1 + [7, 7, 7]))  # prefix hit on sealed blocks
    a.free_sequence(s1)
    a.note_tokens_computed(s2, (p1 + [7, 7, 7])[s2.cached_tokens:])
    a.free_sequence(s2)
    # pressure: evicts the LRU cached blocks (spilled to the host tier)
    s3 = note(a.allocate_sequence(list(range(200, 240))))
    a.note_tokens_computed(s3, list(range(200, 240)))
    a.free_sequence(s3)
    s4 = note(a.allocate_sequence(p1 + [5]))  # host-tier hits continue the chain
    trace.append((a.free_blocks, a.active_blocks, a.reclaimable_blocks, a.hit_tokens,
                  a.probe_tokens, a.inflight_waits, a.peak_active_blocks))
    a.free_sequence(s4)
    trace.append(note(a.allocate_sequence(list(range(1000, 1100)))))  # too long: None
    return trace, sink.events


def test_allocator_matches_jax_package():
    jt, je = _run(jax_alloc)
    pt, pe = _run(port_alloc)
    assert pt == jt
    assert pe == je
    assert any(e[0] == "removed" for e in pe) and any(e[0] == "stored" for e in pe)
