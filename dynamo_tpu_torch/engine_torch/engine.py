"""The continuous-batching torch serving engine.

Counterpart of the main path of the JAX package's ``engine_jax/engine.py``:

- **Fixed batch slots**: ``max_slots`` lanes; a request holds one slot from
  its first prefill chunk to its finish.
- **Chunked, batched prefill**: a step with a prefilling lane runs one
  ``[slots, prefill_chunk]`` forward (``models/llama.py::forward_chunk``) in
  which prefilling lanes consume up to a chunk of prompt while decode lanes
  advance one token.
- **Windowed, pipelined decode**: a decode dispatch runs ``decode_steps``
  steps of ``forward_window`` (the pool is read through the paged
  flash-decode kernel; fresh K/V go to a window buffer) and flushes the
  window into the pages once (``flush_window``). The next dispatch is
  enqueued off the previous one's device-resident carry before the host
  fetches the previous tokens, so the device→host copy overlaps compute.
- **Paged KV** with content-addressed prefix reuse (``allocator.py``).
- **Sampling beside the step** (``sampling.py``): only token ids (and, when
  asked for, logprobs) cross to the host.
- **Step loop on a dedicated thread**, which sets its CUDA device; tokens
  reach requesters through ``loop.call_soon_threadsafe`` into per-request
  asyncio queues.

- **Weight-only int8** (``EngineConfig.quantize``, the JAX modes):
  ``"int8"`` decodes from an int8 copy of the weights (``params_decode``)
  and prefills from the bf16 ones (``params``); ``"int8-all"`` keeps only
  the int8 tree for both. Int8 products go through the W8A16 kernels (an
  MoE expert stack in one launch).
- **The mixtral family** needs nothing of its own here: the model's MLP
  block routes through ``ops/moe.py``, padding lanes masked out of routing
  by their positions.
- **Int8 KV pages** (``EngineConfig.kv_dtype`` or ``DYN_TPU_KV_DTYPE``, the
  JAX knobs): the pool stores int8 pages and per-token fp32 scales
  (``models/llama.py``); decode reads it through the int8 paged kernel.
- **The host-RAM KV tier** (``EngineConfig.host_cache_blocks``): blocks
  evicted from the device pool are gathered on the engine's stream and
  copied to pinned host memory behind a CUDA event (``_offload_blocks``),
  moved into the allocator's ``HostKvPool`` once the copy is done
  (``_harvest_spills``), and written back into a new sequence's pages on a
  prefix hit before any compute touches it (``_inject_host_hits``). An
  int8 pool's scales travel with their pages.

- **The integrity plane** (``runtime/integrity.py``, on unless
  ``DYN_TPU_KV_INTEGRITY=0``, as in the JAX engine): each sealed block gets
  a crc32 of its pages, computed off the engine thread from a pinned copy
  (``_block_checksums``); the crc travels with the block into the host
  tier and is verified at the rehit (a corrupt entry is a prefix miss).
  The step functions carry the output watchdog: a lane whose sampled
  logits are non-finite or exceed ``logit_limit`` gets
  ``WATCHDOG_TOKEN``, and the engine ends its stream in-band
  (``_watchdog_trip``). The engine plane of ``runtime/faults.py`` drives
  the drills (``poison`` at each dispatch, ``corrupt`` at each spill).
- **Self-draft speculative decoding** (``EngineConfig.spec_k`` or
  ``DYN_TPU_SPEC_K``; off by default): each request gets an n-gram drafter
  (``drafter.py``); when every lane decodes and some drafter has a match,
  one verify dispatch scores ``[last token, drafts..]`` per lane through
  ``forward_chunk`` and samples a target at every position
  (``sampling.speculative_targets``); the matching drafted prefix plus the
  first target are emitted.

- **Tensor parallelism** (``mesh=``, a tp mesh of ``parallel/mesh.py``;
  ``build_torch_serving_engine(..., tensor_parallel_size=N)``): the
  weights are a :class:`ShardedParams` (Megatron heads, MLP and vocab), the
  pool one per rank sharded by kv head, the window buffers per rank, and
  every forward runs the ranks with their collectives
  (``models/llama.py``). Rank 0's device is the engine's: host uploads,
  sampling, logits and the decode carry live there. Pages leave and enter
  the pool in global head order (the rank pools concatenated along the kv
  heads), so seal checksums equal the JAX ``page_checksums`` of the global
  pool and host-tier pages are interchangeable with an unsharded engine's.
  As the JAX engine on a mesh: int8 KV pages raise, the output watchdog is
  off, ``"int8"`` weights serve (the whole tree's quantization, sharded),
  speculation runs. ``"int8-all"`` serves on a mesh too, where the JAX
  engine leaves its quantized tree unsharded: ``params`` and
  ``params_decode`` are one sharded int8 tree (the whole tree's
  quantization, sharded; random or checkpoint weights quantized as each
  matrix is drawn or read, then sliced), and every product of the prefill
  chunk and the decode window runs per rank on the W8A16 kernels. The
  mixtral family serves on a mesh with every expert at F/tp on each rank
  (``ops/moe.py``). Heads that do not split over tp raise (ROADMAP A11),
  as do ep, pp and sp (A7).

- **The observability planes**, on by default as in the JAX engine: each
  finished request records retroactive ``engine.request`` → queue-wait /
  prefill / decode spans under the trace its context carries
  (``runtime/tracing.py``, ``DYN_TPU_TRACE=0`` turns it off); the
  telemetry plane's live decode gauges (``_EnginePerf``,
  ``DYN_TPU_SLO=0``); the heartbeat, beaten once per step-loop iteration
  (``runtime/health.py``). Opt-in: the dispatch timeline
  (``DYN_TPU_PROFILE=1``, every ``DYN_TPU_PROFILE_SAMPLE``-th dispatch
  timed, its device time by the segment-gated ``device_timer.py``) and the
  straggler feed (``DYN_TPU_STRAGGLER=1``, every dispatch). A plane that is
  off costs one ``None`` check per dispatch.

Not in this engine yet (later slices, ROADMAP.md): disaggregated prefill,
live migration, QoS, dp/pp/sp/ep meshes.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, AsyncIterator, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..llm.protocols.common import FinishReason, LLMEngineOutput, PreprocessedRequest
from ..models.llama import (
    LlamaConfig,
    LlamaParams,
    ShardedParams,
    flush_window,
    forward_chunk,
    forward_window,
    lm_head,
    make_kv_cache,
    quantize_params_int8,
    rank_config,
    shard_params,
)
from ..ops import dispatch_gate, int8_matmul, paged_attention
from ..ops.build import build_all
from ..ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_sharded,
)
from ..parallel.mesh import Mesh, MeshConfig, make_mesh
from ..runtime import faults as faults_mod
from ..runtime import integrity as integrity_mod
from ..runtime import profiling as profiling_mod
from ..runtime import straggler as straggler_mod
from ..runtime import telemetry, tracing
from ..runtime.annotated import Annotated
from ..runtime.engine import AsyncEngine, Context
from ..runtime.health import EngineHeartbeat
from ..runtime.integrity import WATCHDOG_TOKEN
from .allocator import (
    BlockAllocator,
    HostKvPool,
    InflightPrefix,
    KvDtypeMismatch,
    KvEventSink,
    SequenceAllocation,
    resolve_crc,
)
from .device_timer import DeviceTimer
from .drafter import MAX_SPEC_K, NgramDrafter, env_spec_k, env_spec_ngram
from .sampling import (
    apply_penalties,
    gumbel_noise,
    sample_tokens,
    speculative_targets,
    token_logprobs,
    update_counts,
)

logger = logging.getLogger(__name__)


class _EnginePerf:
    """Live decode-perf accounting (engine thread only, EMA-smoothed): the
    JAX engine's ``_EnginePerf``. Tokens/s, step time, slot utilization and
    the speculative accept rate as live gauges of ``metrics_snapshot()``.
    Built only when telemetry sampling is enabled (``DYN_TPU_SLO=0`` ⇒ the
    engine holds ``None`` and the step loop pays one attribute check).

    Timing anchors on the gap between consecutive *processed* decode
    dispatches (which in pipelined decode equals the dispatch's wall time);
    idle gaps are excluded via :meth:`note_idle` so a quiet engine's
    throughput gauge reflects its last busy period instead of decaying
    toward zero.
    """

    __slots__ = (
        "decode_tps", "step_time_ms", "slot_util", "spec_accept_rate",
        "_last_t", "_alpha",
    )

    def __init__(self, alpha: float = 0.2):
        self.decode_tps = 0.0
        self.step_time_ms = 0.0
        self.slot_util = 0.0
        # acceptance-rate EMA over verify dispatches (accepted drafts /
        # drafted); 0.0 with speculation off or before the first draft
        self.spec_accept_rate = 0.0
        self._last_t: Optional[float] = None
        self._alpha = alpha

    def _ema(self, prev: float, sample: float) -> float:
        return sample if prev == 0.0 else prev + self._alpha * (sample - prev)

    def note_decode(self, n_tokens: int, k_steps: int) -> None:
        now = time.perf_counter()
        last, self._last_t = self._last_t, now
        if last is None:
            return
        dt = now - last
        if dt <= 0:
            return
        if n_tokens > 0:
            self.decode_tps = self._ema(self.decode_tps, n_tokens / dt)
        self.step_time_ms = self._ema(
            self.step_time_ms, dt * 1e3 / max(k_steps, 1)
        )

    def note_slots(self, active: int, total: int) -> None:
        if total > 0:
            self.slot_util = self._ema(self.slot_util, active / total)

    def note_spec(self, drafted: int, accepted: int) -> None:
        if drafted > 0:
            self.spec_accept_rate = self._ema(
                self.spec_accept_rate, accepted / drafted
            )

    def note_idle(self) -> None:
        self._last_t = None


def resolve_device(device: Optional[str]) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU. A CUDA
    request on a machine without a card raises instead of running slowly
    on the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu (device='cpu') to "
            "run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _watchdog_bad(sel: torch.Tensor, wdf: torch.Tensor, limit: float):
    """The output watchdog on logit rows [..., V]: the poison drill's NaN
    substitution (``wdf`` > 0, a device scalar), then each row's flag: any
    non-finite value, or a |logit| above ``limit``. ``full_like`` keeps the
    rows' dtype, so a healthy dispatch samples exactly what it would
    without the watchdog."""
    sel = torch.where(wdf > 0, torch.full_like(sel, float("nan")), sel)
    bad = ~torch.isfinite(sel).all(dim=-1) | (sel.abs().amax(dim=-1) > limit)
    return sel, bad


KV_DTYPES = (None, "bf16", "int8")
# pending host-tier spills past which the engine waits for them (JAX :1630)
MAX_PENDING_SPILLS = 8


def env_kv_dtype(default: str = "bf16") -> str:
    """``DYN_TPU_KV_DTYPE``: only ``int8`` (any case, spaces stripped)
    selects int8 pages; any other value, a typo included, is the native
    layout, so that a typo never quantizes a fleet's KV."""
    raw = (os.environ.get("DYN_TPU_KV_DTYPE") or "").strip().lower()
    return "int8" if raw == "int8" else default


@dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    kv_block_size: int = 16
    max_model_len: int = 2048
    num_kv_blocks: Optional[int] = None  # default: 1.5x what max_slots need
    # prompt tokens consumed per prefilling lane per step
    prefill_chunk: int = 128
    # decode steps per dispatch (tokens past a stop are discarded host-side)
    decode_steps: int = 1
    # alternatives computed per step for OpenAI logprobs (OpenAI's bound)
    top_logprobs: int = 20
    # idle engine: wait up to this long for an admission wave to land
    admission_window: float = 0.02
    # weight-only quantization (models/llama.py quantize_params_int8):
    # "int8" decodes from an int8 copy and prefills from the bf16 weights
    # (1.5x weight residency); "int8-all" keeps only int8 for both phases
    # (the fit mode); None serves the weights as given
    quantize: Optional[str] = None
    # KV page storage: "bf16" (the native layout, in the model's dtype) or
    # "int8" (int8 pages and per-token fp32 scales); None reads
    # DYN_TPU_KV_DTYPE
    kv_dtype: Optional[str] = None
    # host-RAM KV tier, in blocks (0 = off): evicted device blocks spill
    # there and serve later prefix hits
    host_cache_blocks: int = 0
    # self-draft speculative decoding (drafter.py): draft tokens verified
    # per decode dispatch, clamped to [0, MAX_SPEC_K] (0 = off); None reads
    # DYN_TPU_SPEC_K
    spec_k: Optional[int] = None
    # longest trailing n-gram the drafter probes; None reads
    # DYN_TPU_SPEC_NGRAM
    spec_ngram: Optional[int] = None

    def __post_init__(self) -> None:
        # the env knob degrades a typo to the native layout; an explicit
        # value outside the set is a programming error
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype={self.kv_dtype!r} not in {{None, 'bf16', 'int8'}}")

    def resolve_num_blocks(self) -> int:
        if self.num_kv_blocks is not None:
            return self.num_kv_blocks
        per_seq = math.ceil(self.max_model_len / self.kv_block_size)
        return int(self.max_slots * per_seq * 3 // 2)

    @property
    def max_blocks_per_seq(self) -> int:
        return math.ceil(self.max_model_len / self.kv_block_size)


class _Seq:
    """One in-flight request's host-side state."""

    __slots__ = (
        "ctx", "request", "prompt", "alloc", "slot", "out_queue", "loop",
        "generated", "emitted", "max_tokens", "eos_ids", "ignore_eos",
        "temperature", "top_k", "top_p", "seed", "logprobs", "enqueue_t",
        "first_token_t", "admit_t", "prefill_pos", "freq_pen", "pres_pen",
        "out_tokens", "joined_inflight", "wait_hash", "drafter",
        "spec_drafted", "spec_accepted",
    )

    def __init__(self, ctx: Context, request: PreprocessedRequest, loop) -> None:
        self.ctx = ctx
        self.request = request
        self.prompt: List[int] = list(request.token_ids)
        self.alloc: Optional[SequenceAllocation] = None
        self.slot: Optional[int] = None
        self.out_queue: asyncio.Queue = asyncio.Queue()
        self.loop = loop
        self.generated: List[int] = []
        # tokens streamed to the caller — survives preemption
        self.emitted = 0
        sc = request.stop_conditions
        self.max_tokens = sc.max_tokens if sc.max_tokens is not None else 2**30
        self.eos_ids: Set[int] = set(request.eos_token_ids or [])
        self.ignore_eos = bool(sc.ignore_eos)
        so = request.sampling_options
        self.temperature = so.temperature if so.temperature is not None else 0.0
        self.top_k = so.top_k if so.top_k is not None else 0
        self.top_p = so.top_p if so.top_p is not None else 1.0
        self.seed = so.seed if so.seed is not None else 0
        self.freq_pen = so.frequency_penalty or 0.0
        self.pres_pen = so.presence_penalty or 0.0
        # every output token ever emitted (rebuilds the penalty counts)
        self.out_tokens: List[int] = []
        self.logprobs = so.logprobs
        self.enqueue_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self.admit_t: Optional[float] = None
        self.joined_inflight = False
        self.wait_hash: Optional[int] = None
        # next prompt position to compute while prefilling; None = decoding
        self.prefill_pos: Optional[int] = None
        # the request's n-gram drafter (speculation on), and its counts
        self.drafter: Optional[NgramDrafter] = None
        self.spec_drafted = 0
        self.spec_accepted = 0

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def penalized(self) -> bool:
        return self.freq_pen != 0.0 or self.pres_pen != 0.0

    def emit(self, item) -> None:
        # the consumer's loop may be gone (client teardown): nobody can
        # receive the item, and writing into a closed loop could wedge
        # the engine thread
        if self.loop.is_closed():
            return
        try:
            self.loop.call_soon_threadsafe(self.out_queue.put_nowait, item)
        except RuntimeError:
            pass


_FINISHED = object()  # sentinel closing a request's output queue


class _HostFetch:
    """A device tensor's device→host copy, started at construction: on CUDA
    into pinned memory behind an event (stream-ordered right after the
    work that produced it), so :meth:`get` later waits only for that work."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t
            self._event = None

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class _Inflight:
    """A dispatched-but-unprocessed decode dispatch (pipelined decode): host
    fetches of its tokens (and logprobs), the device carry (last token and
    position per lane) and the lane→sequence snapshot at dispatch time."""

    __slots__ = ("out", "lps", "top_ids", "top_lps", "tokens", "positions", "lanes")

    def __init__(self, out, lps, top_ids, top_lps, tokens, positions, lanes):
        self.out = out
        self.lps = lps
        self.top_ids = top_ids
        self.top_lps = top_lps
        self.tokens = tokens
        self.positions = positions
        self.lanes = lanes


class TorchServingEngine(AsyncEngine):
    """Continuous-batching paged-KV engine over an eager Llama step."""

    def __init__(
        self,
        model_config: LlamaConfig,
        params: LlamaParams,
        engine_config: EngineConfig = EngineConfig(),
        device="cuda",
        event_sink: Optional[KvEventSink] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.model_config = model_config
        self.config = engine_config
        # a tp mesh: rank 0's device is the engine's
        self.mesh = mesh
        self.device = resolve_device(str(mesh.devices[0] if mesh is not None else device))
        if mesh is not None:
            rank_config(model_config, mesh.tp)  # raises on what tp does not shard
            if not isinstance(params, ShardedParams):
                params = shard_params(params, model_config, mesh)
        elif isinstance(params, ShardedParams):
            raise ValueError("sharded params need the engine's mesh (mesh=)")
        if engine_config.quantize == "int8-all":
            # int8 for both phases and the bf16 tree dropped; a tree that is
            # already quantized is taken as it is
            if not params.int8:
                params = quantize_params_int8(params, model_config)
        elif engine_config.quantize == "int8":
            # hybrid: decode reads the int8 copy (the weights are the decode
            # bytes), prefill keeps the bf16 weights
            self.params_decode = quantize_params_int8(params, model_config)
        elif engine_config.quantize:
            raise ValueError(f"unknown quantize mode {engine_config.quantize!r}")
        if engine_config.quantize != "int8":
            self.params_decode = params
        self.params = params
        # self-draft speculation: the config wins when set, else the
        # clamped env parsers; spec_k = 0 (the default) never touches a
        # drafter or builds a verify function
        sk = engine_config.spec_k if engine_config.spec_k is not None else env_spec_k()
        self._spec_k = max(0, min(int(sk), MAX_SPEC_K))
        self._spec_ngram = (
            engine_config.spec_ngram if engine_config.spec_ngram is not None
            else env_spec_ngram()
        )
        # integrity plane: seal checksums and the output watchdog. None with
        # DYN_TPU_KV_INTEGRITY=0: no checksum callback, no crc thread, and
        # the step functions are exactly the ones without the plane
        self._integrity = integrity_mod.maybe_from_env()
        # the watchdog is single-device, as in the JAX engine: a tp engine
        # keeps the seal checksums and dispatches without it
        self._watchdog = self._integrity is not None and mesh is None
        # the address the fault rules match on (one worker in a fleet)
        self._fault_addr = "engine"
        # seal checksums: blocks sealed since the last flush, as (block ids,
        # futures); a flush gathers their pages on the engine's stream and
        # a worker thread computes the crcs once the copy has landed
        self._crc_batch: List[Tuple[List[int], List[Future]]] = []
        self._crc_pool: Optional[ThreadPoolExecutor] = None
        self._wd_zero: Optional[torch.Tensor] = None
        self.crc_seconds = 0.0  # worker-thread seconds computing crcs
        self.crc_blocks = 0
        self.crc_flush_seconds = 0.0  # engine-thread seconds starting them
        self.num_blocks = engine_config.resolve_num_blocks()
        self.host_pool = (
            HostKvPool(engine_config.host_cache_blocks)
            if engine_config.host_cache_blocks > 0 else None
        )
        # spills on their way to the host pool: (pairs, host k, v, k_scale,
        # v_scale, CUDA event or None), oldest first
        self._pending_spills: Deque[tuple] = deque()
        self.allocator = BlockAllocator(
            self.num_blocks, engine_config.kv_block_size, event_sink=event_sink,
            host_pool=self.host_pool,
            offload=self._offload_blocks if self.host_pool is not None else None,
            checksum=self._block_checksums if self._integrity is not None else None,
        )
        self.kv_quantized = (engine_config.kv_dtype or env_kv_dtype()) == "int8"
        if self.kv_quantized and mesh is not None:
            raise ValueError("kv_dtype='int8' requires an unsharded cache (mesh=None); "
                             "sharded engines keep the native KV dtype")
        # the pool: one dict, or on a mesh one per rank (its kv heads)
        self.cache = make_kv_cache(
            model_config, self.num_blocks, engine_config.kv_block_size,
            device=self.device, quantized=self.kv_quantized, mesh=mesh,
        )
        self._rank_pools: List[Dict[str, torch.Tensor]] = (
            self.cache if mesh is not None else [self.cache])

        S = engine_config.max_slots
        MB = engine_config.max_blocks_per_seq
        self._slots: List[Optional[_Seq]] = [None] * S
        self._tables = np.zeros((S, MB), np.int32)
        self._last_tokens = np.zeros((S,), np.int32)
        self._positions = np.full((S,), -1, np.int32)
        self._temp = np.zeros((S,), np.float32)
        self._topk = np.zeros((S,), np.int32)
        self._topp = np.ones((S,), np.float32)
        self._seeds = np.zeros((S,), np.int64)
        self._freqp = np.zeros((S,), np.float32)
        self._presp = np.zeros((S,), np.float32)

        # [S, V] output-token counts for the penalties, allocated on the
        # first penalized request and rebuilt per changed lane
        self._counts: Optional[torch.Tensor] = None
        self._counts_lanes: List[Optional[_Seq]] = [None] * S

        self._step_counter = 0
        self._pending: Deque[_Seq] = deque()
        self._cond = threading.Condition()
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None

        # pipelined decode: at most one dispatched-but-unprocessed dispatch,
        # plus allocations that may still receive its speculative writes
        self._inflight: Optional[_Inflight] = None
        self._zombie_allocs: List[SequenceAllocation] = []

        # (with_logprobs, with_penalties, with_sampling) step variants
        self._decode_fns: Dict[Tuple[bool, bool, bool], Any] = {}
        self._chunk_fns: Dict[Tuple[bool, bool, bool, bool], Any] = {}
        self._verify_fns: Dict[Tuple[bool, bool, bool], Any] = {}

        # stats
        self.total_requests = 0
        self.total_generated_tokens = 0
        self.total_prompt_tokens = 0
        self.preemptions = 0
        self.decode_dispatches = 0
        self.decode_steps_total = 0
        self.chunk_dispatches = 0
        self.verify_dispatches = 0
        self.verify_tokens = 0  # tokens emitted by verify dispatches
        self.watchdog_trips = 0
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        # seconds from enqueue to first token of the latest requests
        self.recent_ttft_s: Deque[float] = deque(maxlen=1024)

        # health plane: the step loop beats this once per iteration; a busy
        # engine whose beats stop is a wedged engine thread
        self.heartbeat = EngineHeartbeat()
        # live perf accounting (telemetry plane): None when sampling is off,
        # so the step loop's only cost is this attribute's None-check
        self._perf: Optional[_EnginePerf] = (
            _EnginePerf() if telemetry.enabled() else None
        )
        # performance attribution plane (runtime/profiling.py): sampled
        # per-dispatch host/device/alloc timing into the process-global
        # StepTimeline. None with DYN_TPU_PROFILE off: the step loop then
        # pays one None-check per dispatch and no timeline, no device timer
        # is ever constructed
        profile = profiling_mod.maybe_from_env()
        self._timeline = profiling_mod.timeline() if profile is not None else None
        self._device_timer = DeviceTimer(self.device) if profile is not None else None
        # allocator microseconds (alloc/grow/seal-checksum) accrued since the
        # last dispatch record: admission allocs between dispatches charge
        # the NEXT dispatch's record
        self._prof_alloc_us = 0.0
        # fail-slow plane (runtime/straggler.py): every dispatch's wall
        # microseconds per token into the process-global detector. None with
        # DYN_TPU_STRAGGLER off (one None-check per dispatch, no detector)
        self._straggler = straggler_mod.maybe_detector()

    def _put(self, host_arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host_arr)).to(self.device)

    # -- step functions -------------------------------------------------------

    def _decode(self, want_lp: bool, want_pen: bool = False, want_sample: bool = True):
        key = (want_lp, want_pen, want_sample)
        fn = self._decode_fns.get(key)
        if fn is None:
            fn = self._decode_fns[key] = self._build_decode_fn(*key)
        return fn

    def _build_decode_fn(self, with_lp: bool, with_pen: bool, with_sample: bool):
        cfg = self.model_config
        k_steps = self.config.decode_steps
        max_pos = self.config.max_model_len - 1
        n_top = self.config.top_logprobs
        S = self.config.max_slots
        # the window buffers: one per rank on a mesh, its kv heads
        tp = self.mesh.tp if self.mesh is not None else 1
        kvh = rank_config(cfg, tp).num_kv_heads
        wshape = (cfg.num_layers, S, k_steps, kvh, cfg.head_dim)
        devices = self.mesh.devices if self.mesh is not None else (self.device,)
        # output watchdog: with the integrity plane on, the function takes
        # one more argument (``wdf``, the poison drill's device scalar) and
        # substitutes WATCHDOG_TOKEN for a lane whose logits trip it
        wd = self._watchdog
        wd_limit = self._integrity.logit_limit if wd else 0.0

        def decode(tokens, positions, tables, step_ctr, seeds, temp_host, topk,
                   temp, topp, freqp, presp, counts, wdf=None, layer_hook=None):
            # k_steps forward+sample iterations, each sampled token fed back
            # in; the pool is read-only inside, the window is flushed once
            base = positions
            wk = [torch.zeros(wshape, dtype=cfg.dtype, device=d) for d in devices]
            wv = [torch.zeros(wshape, dtype=cfg.dtype, device=d) for d in devices]
            if self.mesh is None:
                wk, wv = wk[0], wv[0]
            toks, pos = tokens, positions
            outs, lps, tids, tlps = [], [], [], []
            for k in range(k_steps):
                logits, wk, wv = forward_window(
                    self.params_decode, cfg, toks, pos, self.cache, tables, base, wk, wv, k,
                    layer_hook=layer_hook,
                )
                if wd:
                    logits, bad = _watchdog_bad(logits, wdf, wd_limit)
                sampled_from = (
                    apply_penalties(logits, counts, freqp, presp) if with_pen else logits
                )
                noise = (
                    gumbel_noise(seeds, temp_host > 0, step_ctr, k, device=self.device)
                    if with_sample else None
                )
                nxt = sample_tokens(sampled_from, temp, topk, topp, noise=noise,
                                    greedy_only=not with_sample)
                if wd:
                    nxt = torch.where(bad & (pos >= 0),
                                      torch.full_like(nxt, WATCHDOG_TOKEN), nxt)
                if with_pen:
                    update_counts(counts, nxt, pos >= 0)
                if with_lp:
                    lp, ti, tl = token_logprobs(logits, nxt, n_top)
                    lps.append(lp)
                    tids.append(ti)
                    tlps.append(tl)
                outs.append(nxt)
                pos = torch.where((pos >= 0) & (pos < max_pos), pos + 1,
                                  torch.full_like(pos, -1))
                toks = nxt
            flush_window(self.cache, tables, base, wk, wv, max_pos, layer_hook=layer_hook)
            out = torch.stack(outs, dim=1)  # [S, k_steps]
            if with_lp:
                return (out, torch.stack(lps, 1), torch.stack(tids, 1),
                        torch.stack(tlps, 1), toks, pos)
            return out, None, None, None, toks, pos

        return decode

    def _chunk(self, want_lp: bool, want_pen: bool = False, want_sample: bool = True,
               want_history: bool = True):
        key = (want_lp, want_pen, want_sample, want_history)
        fn = self._chunk_fns.get(key)
        if fn is None:
            fn = self._chunk_fns[key] = self._build_chunk_fn(*key)
        return fn

    def _build_chunk_fn(self, with_lp: bool, with_pen: bool, with_sample: bool,
                        with_history: bool):
        cfg = self.model_config
        S = self.config.max_slots
        n_top = self.config.top_logprobs
        wd = self._watchdog
        wd_limit = self._integrity.logit_limit if wd else 0.0

        def chunk(tokens, positions, tables, sample_at, step_ctr, seeds, temp_host,
                  topk, temp, topp, freqp, presp, counts, wdf=None, layer_hook=None):
            # tokens/positions [S, C] (-1 positions = padding); sample_at [S]
            # picks the position whose logits are sampled (-1: unused); the
            # LM head runs on those [S, E] rows only
            h, _ = forward_chunk(
                self.params, cfg, tokens, positions, self.cache, tables,
                hidden_only=True, with_history=with_history, layer_hook=layer_hook,
            )
            rows = torch.arange(S, device=self.device)
            hs = h[rows, sample_at.clamp(min=0).long()]
            sel = lm_head(self.params, cfg, hs)
            if wd:
                sel, bad = _watchdog_bad(sel, wdf, wd_limit)
            sampled_from = apply_penalties(sel, counts, freqp, presp) if with_pen else sel
            noise = (
                gumbel_noise(seeds, temp_host > 0, step_ctr, 0, device=self.device)
                if with_sample else None
            )
            nxt = sample_tokens(sampled_from, temp, topk, topp, noise=noise,
                                greedy_only=not with_sample)
            if wd:
                nxt = torch.where(bad & (sample_at >= 0),
                                  torch.full_like(nxt, WATCHDOG_TOKEN), nxt)
            if with_pen:
                update_counts(counts, nxt, sample_at >= 0)
            if with_lp:
                return (nxt,) + token_logprobs(sel, nxt, n_top)
            return nxt, None, None, None

        return chunk

    def _verify(self, want_lp: bool, want_pen: bool = False, want_sample: bool = True):
        """The speculative-verify variant, built lazily like the decode and
        chunk variants, and never while spec_k == 0."""
        key = (want_lp, want_pen, want_sample)
        fn = self._verify_fns.get(key)
        if fn is None:
            fn = self._verify_fns[key] = self._build_verify_fn(*key)
        return fn

    def _build_verify_fn(self, with_lp: bool, with_pen: bool, with_sample: bool):
        """One speculative-verify dispatch: ``[last_token, draft_0, ..,
        draft_{k-1}]`` per lane ([S, K1], -1 positions = padding) through
        ``forward_chunk`` over the decode weights, the LM head on every fed
        position, and the engine's own target token sampled at each
        (``speculative_targets``). The host keeps the drafted prefix that
        matches the targets plus the first non-matching target."""
        cfg = self.model_config
        n_top = self.config.top_logprobs
        wd = self._watchdog
        wd_limit = self._integrity.logit_limit if wd else 0.0

        def verify(tokens, positions, tables, step_ctr, seeds, temp_host, topk,
                   temp, topp, freqp, presp, counts, wdf=None, layer_hook=None):
            # KV for every fed position is written by the forward; positions
            # past the accepted prefix hold garbage that later dispatches
            # overwrite before any position mask lets it be attended
            params = self.params_decode
            h, _ = forward_chunk(
                params, cfg, tokens, positions, self.cache, tables,
                hidden_only=True, with_history=True, layer_hook=layer_hook,
            )
            b, k1 = positions.shape
            logits_all = lm_head(params, cfg, h.reshape(b * k1, -1)).reshape(b, k1, -1)
            if wd:
                logits_all, bad_pos = _watchdog_bad(logits_all, wdf, wd_limit)
                bad = (bad_pos & (positions >= 0)).any(dim=-1)  # [S]
            outs = speculative_targets(
                logits_all, counts, positions >= 0, seeds, temp_host > 0, step_ctr,
                temp, topk, topp, freqp, presp,
                with_pen=with_pen, with_sample=with_sample, with_lp=with_lp, n_top=n_top,
            )
            tgt = outs[0]
            if wd:
                tgt = torch.where(bad[:, None], torch.full_like(tgt, WATCHDOG_TOKEN), tgt)
            if with_lp:
                return (tgt,) + tuple(outs[1:4])
            return tgt, None, None, None

        return verify

    # -- integrity ------------------------------------------------------------

    def _wd_args(self) -> tuple:
        """Extra dispatch arguments of the output watchdog: none with the
        integrity plane off, else one device scalar, 1 when the ``poison``
        fault fires for this dispatch and otherwise the 0 uploaded once."""
        if self._watchdog and faults_mod.current() is not None and (
            faults_mod.poison_gate("engine", self._fault_addr)
        ):
            return (self._put(np.int32(1)),)
        return self._wd_steady()

    def _wd_steady(self) -> tuple:
        """The watchdog's arguments when no fault fires: () with the plane
        off (or on a mesh), else the device 0 uploaded once."""
        if not self._watchdog:
            return ()
        if self._wd_zero is None:
            self._wd_zero = self._put(np.int32(0))
        return (self._wd_zero,)

    def _dispatch_args(self, lanes: List[Optional[_Seq]]) -> tuple:
        """What every dispatch settles right before it launches: its
        variant (logprobs, penalties, sampling), the penalty count rows,
        and the watchdog's argument; then the ``slow`` fault, and the seal
        checksums' flush, the last thing before a page can be overwritten.
        Returns ((want_lp, want_pen, want_sample), counts, watchdog args)."""
        want = (
            any(s is not None and s.logprobs is not None for s in lanes),
            any(s is not None and s.penalized for s in lanes),
            any(s is not None and s.temperature > 0.0 for s in lanes),
        )
        counts = self._sync_counts(lanes) if want[1] else self._dummy_counts()
        wd = self._wd_args()
        self._slow_fault()
        self._flush_crcs()
        return want, counts, wd

    def _slow_fault(self) -> None:
        """The ``slow`` fault action at the dispatch point: an injected
        host-side delay right before the dispatch."""
        if faults_mod.current() is not None:
            d = faults_mod.slow_gate("engine", self._fault_addr)
            if d > 0:
                time.sleep(d)

    def _block_checksums(self, block_ids: List[int]) -> List[Future]:
        """The allocator's seal-time checksum callback (engine thread):
        one future per block, resolved off the engine thread once
        :meth:`_flush_crcs` has copied the pages out."""
        futs = [Future() for _ in block_ids]
        self._crc_batch.append((list(block_ids), futs))
        return futs

    def _flush_crcs(self) -> None:
        """Start the checksums of every block sealed since the last flush
        (engine thread). Called before anything can overwrite a page (each
        dispatch, each injection) and before any crc is read. One gather
        per flush into block-major buffers [n, L, bs, ...] (each block's
        bytes contiguous, in the JAX checksum's order) on the engine's
        stream; on CUDA a copy into pinned memory behind an event; a worker
        thread polls the event and computes each block's crc32 (zlib
        releases the GIL), so the engine thread never waits for the card
        here."""
        if not self._crc_batch:
            return
        t0 = time.perf_counter()
        bids = [b for ids, _ in self._crc_batch for b in ids]
        futs = [f for _, fs in self._crc_batch for f in fs]
        self._crc_batch = []
        bufs = self._gather_pages(bids, block_major=True)
        event = None
        if self.device.type == "cuda":
            host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in bufs]
            for h, b in zip(host, bufs):
                h.copy_(b, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            bufs = host
        if self._crc_pool is None:
            self._crc_pool = ThreadPoolExecutor(1, thread_name_prefix="torch-engine-crc")
        self._crc_pool.submit(self._crc_job, bufs, event, futs)
        self.crc_flush_seconds += time.perf_counter() - t0

    def _pool_names(self) -> Tuple[str, ...]:
        return ("k", "v", "k_scale", "v_scale") if self.kv_quantized else ("k", "v")

    def _gather_pages(self, block_ids: List[int], block_major: bool = False
                      ) -> List[torch.Tensor]:
        """The pool's pages of ``block_ids`` on the engine's device, one
        fresh tensor per pool name: ``[L, n, bs, KVH, D]`` (scales ``[L,
        n, bs]``), or with ``block_major`` ``[n, L, ...]`` with each block's
        bytes contiguous (the order of the JAX checksum). On a mesh the rank
        pools are concatenated along the kv-head axis: the global pool's
        pages, in global head order."""
        out = []
        for name in self._pool_names():
            parts = []
            for pool in self._rank_pools:
                x = pool[name]
                idx = torch.tensor(block_ids, dtype=torch.int64, device=x.device)
                x = x.transpose(0, 1)[idx].contiguous() if block_major else x[:, idx]
                parts.append(x if x.device == self.device else x.to(self.device))
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=3))
        return out

    def pages(self, block_ids: List[int]) -> Dict[str, torch.Tensor]:
        """The pool's pages of ``block_ids`` by name (``k``, ``v`` and an
        int8 pool's scales), ``[L, n, bs, KVH, D]`` in global head order on
        the engine's device: what a host-tier spill of these blocks holds.
        Engine thread (or an idle engine) only."""
        return dict(zip(self._pool_names(), self._gather_pages(block_ids)))

    def _crc_job(self, bufs: List[torch.Tensor], event, futs: List[Future]) -> None:
        """Worker thread: each block's crc32 over its k | v (| scales)
        bytes into its future; a failure goes into the futures not yet
        resolved, where the reader of a checksum raises it."""
        try:
            # polled, not waited on: the wait must hold no lock the engine
            # thread needs
            while event is not None and not event.query():
                time.sleep(0.0002)
            t0 = time.perf_counter()
            for i, fut in enumerate(futs):
                fut.set_result(integrity_mod.entry_checksum(*(b[i] for b in bufs)))
            self.crc_seconds += time.perf_counter() - t0
            self.crc_blocks += len(futs)
        except Exception as e:  # noqa: BLE001 - delivered to each checksum's reader
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _watchdog_trip(self, seq: "_Seq", defer_free: bool = False) -> None:
        """The lane's dispatch produced non-finite or exploding logits: end
        its stream in-band with a resume directive (the JAX engine's items:
        a ``migrating`` item, then the end of the stream). Nothing of the
        tripped dispatch is emitted or sealed; the trip counts against this
        worker's quarantine window. Engine thread only."""
        self.watchdog_trips += 1
        integrity_mod.note_trip("watchdog", where="engine")
        logger.error(
            "output watchdog tripped for request %s: non-finite or exploding "
            "logits; ending the stream with a resume directive", seq.ctx.id,
        )
        if tracing.enabled():
            self._record_phase_spans(seq, FinishReason.ERROR)
        self._release_lane(seq, defer_free)
        seq.emit(Annotated.from_data(
            {"migrating": {
                "resume": True,
                "error": "output watchdog: non-finite or exploding logits",
            }},
            id=seq.ctx.id,
        ))
        seq.emit(_FINISHED)

    # -- performance attribution (runtime/profiling.py, runtime/straggler.py) --

    def _launch(self, fn, args: tuple):
        """Call a step function on its (already uploaded) arguments. With
        profiling armed every dispatch counts into the timeline, and one
        the timeline samples runs under the device timer, its forward
        marking the segment boundaries, when the timer says it may be timed
        (``DeviceTimer.ready``); it is waited for here. Returns (outputs,
        timing): timing is None when not timed (or when a gate timed out),
        else (t_enqueued, device_us, t_ready)."""
        timer = self._device_timer
        if timer is None:
            return fn(*args), None
        # every dispatch tells the timer which step function runs (its
        # first run is never timed), sampled or not
        if not timer.ready(fn, self._timeline.should_sample()):
            return fn(*args), None
        try:
            timer.begin()
            out = fn(*args, layer_hook=timer.mark)
        finally:
            timer.end()  # releases the last gate, whatever happened
        t_enq = time.perf_counter()
        device_us = timer.device_us()
        if device_us is None:
            return out, None
        return out, (t_enq, device_us, time.perf_counter())

    def pause_device_timing(self):
        """A context manager under which no dispatch is timed; on entry the
        timed dispatch in flight has released its gates
        (``DeviceTimer.quiesce``). Enter it from another thread around
        anything that waits for the card while profiling is armed, such as
        ``torch.profiler``'s start and stop; a no-op without the timer."""
        if self._device_timer is None:
            return contextlib.nullcontext()
        return self._device_timer.quiesce()

    def _step_start(self) -> float:
        """A dispatch step's start on the host clock, when a plane reads it."""
        if self._timeline is None and self._straggler is None:
            return 0.0
        return time.perf_counter()

    def _dispatch_done(self, phase: str, t_step: float, timing, batch: int,
                       tokens: int) -> None:
        """A dispatch's end: its record into the timeline when it was timed
        (else the accrued allocator share is dropped, so that it cannot pile
        up across the sampling stride), and its wall time per token into
        the straggler feed, on every dispatch."""
        if timing is not None:
            self._note_dispatch(phase, t_step, *timing, time.perf_counter(), batch, tokens)
        elif self._timeline is not None:
            self._prof_alloc_us = 0.0
        if self._straggler is not None:
            self._straggler.note_dispatch(phase, (time.perf_counter() - t_step) * 1e6, tokens)

    def _note_dispatch(self, phase: str, t_step: float, t_enq: float, device_us: float,
                       t_ready: float, t_end: float, batch: int, tokens: int) -> None:
        """One timed dispatch into the timeline (StepTimeline's field
        definitions): host build + enqueue (``t_step`` → ``t_enq``), the
        device's execution time, host emit work (``t_ready`` → ``t_end``),
        the accrued allocator share, the queue depth, and the request and
        trace ids riding the batch."""
        alloc_us, self._prof_alloc_us = self._prof_alloc_us, 0.0
        reqs: List[str] = []
        traces: List[str] = []
        for s in self._slots:
            if s is None or len(reqs) >= 8:
                continue
            reqs.append(str(s.ctx.id))
            tid = getattr(s.ctx.context.trace, "trace_id", None)
            if tid:
                traces.append(str(tid))
        # epoch-align the perf_counter anchors so captures from different
        # processes merge onto one Perfetto timeline
        now_wall = time.time()
        now_perf = time.perf_counter()
        self._timeline.note_dispatch(
            phase,
            ts=now_wall - (now_perf - t_step),
            step=self._step_counter,
            batch=batch,
            tokens=tokens,
            host_us=(t_enq - t_step) * 1e6,
            device_us=device_us,
            post_us=(t_end - t_ready) * 1e6,
            alloc_us=alloc_us,
            queue=len(self._pending),
            reqs=reqs,
            traces=traces,
        )

    def _alloc_timed(self, fn, *args):
        """An allocator call (allocation; block seal and checksum hand-off)
        whose time accrues to the allocator share of the next dispatch
        record (profiling armed); the bare call otherwise."""
        if self._timeline is None:
            return fn(*args)
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self._prof_alloc_us += (time.perf_counter() - t) * 1e6

    # -- penalty counts -------------------------------------------------------

    def _release_counts(self) -> None:
        if self._counts is not None:
            self._counts = None
            self._counts_lanes = [None] * self.config.max_slots

    def _sync_counts(self, lanes: List[Optional[_Seq]]) -> torch.Tensor:
        """Rebuild the count rows of lanes whose (penalized) sequence changed
        since the last penalized dispatch from its emitted output tokens."""
        S = self.config.max_slots
        if self._counts is None:
            self._counts = torch.zeros(
                (S, self.model_config.vocab_size), dtype=torch.int32, device=self.device
            )
        for i in range(S):
            seq = lanes[i]
            if self._counts_lanes[i] is seq or seq is None or not seq.penalized:
                continue
            self._counts[i].zero_()
            if seq.out_tokens:
                toks = torch.tensor(seq.out_tokens, dtype=torch.int64, device=self.device)
                self._counts[i].index_put_(
                    (toks,), torch.ones_like(toks, dtype=torch.int32), accumulate=True
                )
        self._counts_lanes = list(lanes)
        return self._counts

    def _dummy_counts(self) -> torch.Tensor:
        return torch.zeros((self.config.max_slots, 1), dtype=torch.int32, device=self.device)

    def _sampling_args(self) -> tuple:
        return (
            self._seeds.copy(), self._temp.copy(), self._put(self._topk),
            self._put(self._temp), self._put(self._topp), self._put(self._freqp),
            self._put(self._presp),
        )

    # -- warmup ---------------------------------------------------------------

    def warmup(self) -> Dict[str, float]:
        """Build the kernels and run one all-padding chunk and decode
        dispatch (cuBLAS handles, allocator pools) before serving traffic.
        Returns seconds per part."""
        cfg = self.config
        S, C, MB = cfg.max_slots, cfg.prefill_chunk, cfg.max_blocks_per_seq
        timings: Dict[str, float] = {}
        if self.device.type == "cuda":
            libs = [paged_attention.LIBRARY]
            if self.params.int8 or self.params_decode.int8:
                libs.append(int8_matmul.LIBRARY)
            if self._device_timer is not None:
                libs.append(dispatch_gate.LIBRARY)
            timings["kernel_build"] = max(b["seconds"] for b in build_all(libs).values())
        tables = self._put(np.zeros((S, MB), np.int32))
        neg = self._put(np.full((S,), -1, np.int32))
        samp = self._sampling_args()
        with self._device_scope():
            # the watchdog's steady-state 0, never a fault decision
            wd = self._wd_steady()
            t0 = time.perf_counter()
            self._chunk(False, False, False, False)(
                self._put(np.zeros((S, C), np.int32)),
                self._put(np.full((S, C), -1, np.int32)), tables, neg, 0,
                *samp, self._dummy_counts(), *wd,
            )
            self._sync()
            timings["chunk"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            self._decode(False, False, False)(
                self._put(np.zeros((S,), np.int32)), neg, tables, 0, *samp,
                self._dummy_counts(), *wd,
            )
            self._sync()
            timings["decode"] = time.perf_counter() - t0
            if self._spec_k > 0:
                k1 = self._spec_k + 1
                t0 = time.perf_counter()
                self._verify(False, False, False)(
                    self._put(np.zeros((S, k1), np.int32)),
                    self._put(np.full((S, k1), -1, np.int32)), tables, 0, *samp,
                    self._dummy_counts(), *wd,
                )
                self._sync()
                timings["verify"] = time.perf_counter() - t0
        return timings

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_scope(self):
        return _DeviceScope(self.device)

    # -- AsyncEngine interface ------------------------------------------------

    async def generate(
        self, request: Context[PreprocessedRequest]
    ) -> AsyncIterator[Annotated[dict]]:
        req = request.data
        if not isinstance(req, PreprocessedRequest):
            req = PreprocessedRequest.from_dict(req)
        if len(req.token_ids) > self.config.max_model_len - 1:
            yield Annotated.from_error(
                f"prompt is {len(req.token_ids)} tokens; engine max_model_len "
                f"is {self.config.max_model_len}"
            )
            return
        if not req.token_ids:
            yield Annotated.from_error("prompt is empty")
            return
        self._ensure_thread()
        seq = _Seq(request, req, asyncio.get_running_loop())
        if self._spec_k > 0:
            # one suffix index per request (prompt indexed up front, emitted
            # tokens appended as they stream); spec off keeps it None
            seq.drafter = NgramDrafter(seq.prompt, self._spec_k, self._spec_ngram)
        with self._cond:
            self._pending.append(seq)
            self._cond.notify()
        try:
            while True:
                item = await seq.out_queue.get()
                if item is _FINISHED:
                    return
                yield item
        finally:
            # consumer closed the stream (stop string, disconnect): stop
            # burning the slot; a no-op after a normal finish
            request.context.stop_generating()
            with self._cond:
                self._cond.notify()

    # -- engine thread ----------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._step_loop, name="torch-engine-step", daemon=True
            )
            self._thread.start()

    def close(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._crc_batch:  # no reader may wait on a checksum never started
            with self._device_scope():
                self._flush_crcs()
        if self._crc_pool is not None:
            self._crc_pool.shutdown(wait=True)

    def _step_loop(self) -> None:
        try:
            with self._device_scope():
                while True:
                    with self._cond:
                        while (
                            not self._shutdown
                            and not self._pending
                            and not any(self._slots)
                            and self._inflight is None
                            and self._counts is None  # idle pass frees it first
                            and not self._pending_spills  # idle pass drains them
                            and not self._crc_batch  # idle pass starts them
                        ):
                            # parking idle: record it, or the last busy beat
                            # would age into a false stall
                            self.heartbeat.beat(busy=False)
                            self._cond.wait()
                        if self._shutdown:
                            return
                    # liveness beat BEFORE the work: if the dispatch below
                    # wedges, the recorded busy flag plus a growing beat age
                    # is the stall signature
                    self.heartbeat.beat(busy=bool(
                        self._pending
                        or self._inflight is not None
                        or any(s is not None for s in self._slots)
                        or self._pending_spills
                    ))
                    idle = (
                        not self._pending and not any(self._slots)
                        and self._inflight is None
                    )
                    # an idle engine drains every spill, so that a request
                    # after an idle gap finds its prefix in the host tier
                    self._harvest_spills(force=idle)
                    if idle:
                        self._release_counts()
                        if self._perf is not None:
                            # exclude the idle gap from throughput timing
                            self._perf.note_idle()
                    self._coalesce_admission_wave()
                    self._admit()
                    self._dispatch_step()
        except Exception:
            logger.exception("engine step loop crashed")
            for seq in list(self._slots) + list(self._pending):
                if seq is not None:
                    seq.emit(Annotated.from_error("engine internal error"))
                    seq.emit(_FINISHED)

    # -- scheduling -------------------------------------------------------------

    def _coalesce_admission_wave(self) -> None:
        """Hold the first dispatch briefly while an admission wave is still
        landing, so the whole wave prefills together."""
        window = self.config.admission_window
        if window <= 0:
            return
        if self._inflight is not None or any(s is not None for s in self._slots):
            return
        deadline = time.perf_counter() + window
        with self._cond:
            prev = len(self._pending)
            while (
                0 < prev < self.config.max_slots
                and not self._shutdown
                and time.perf_counter() < deadline
            ):
                self._cond.wait(timeout=0.001)
                if len(self._pending) == prev:
                    return
                prev = len(self._pending)

    def _admit(self) -> None:
        """Move pending requests into free slots."""
        deferred: List[_Seq] = []  # waiting on another lane's in-flight prefix
        try:
            self._admit_inner(deferred)
        finally:
            if deferred:
                with self._cond:
                    for s in reversed(deferred):
                        self._pending.appendleft(s)

    def _try_alloc(self, seq: _Seq, deferred: List[_Seq]):
        """allocate_sequence; an in-flight shared prefix parks the request."""
        alloc = self._alloc_timed(self.allocator.allocate_sequence, seq.prompt)
        if isinstance(alloc, InflightPrefix):
            seq.joined_inflight = True
            seq.wait_hash = alloc.seq_hash
            deferred.append(seq)
            return False
        return alloc

    def _admit_inner(self, deferred: List[_Seq]) -> None:
        while True:
            with self._cond:
                if not self._pending:
                    return
                free = [i for i, s in enumerate(self._slots) if s is None]
                if not free:
                    return
                seq = self._pending.popleft()
            if seq.ctx.context.is_stopped:
                seq.emit(Annotated.from_data(
                    LLMEngineOutput.final(FinishReason.CANCELLED).to_dict()
                ))
                seq.emit(_FINISHED)
                continue
            if seq.wait_hash is not None:
                if self.allocator.inflight_pending(seq.wait_hash):
                    deferred.append(seq)
                    continue
                seq.wait_hash = None
            alloc = self._try_alloc(seq, deferred)
            if alloc is False:
                continue
            if alloc is None and (self._inflight is not None or self._zombie_allocs):
                # blocks may be parked behind the in-flight dispatch
                self._drain_inflight()
                alloc = self._try_alloc(seq, deferred)
                if alloc is False:
                    continue
            if alloc is None:
                if not any(self._slots):
                    # nothing running will ever free blocks: impossible request
                    seq.emit(Annotated.from_error(
                        f"prompt needs {self.allocator.blocks_needed(len(seq.prompt))} "
                        f"KV blocks; pool has {self.num_blocks}"
                    ))
                    seq.emit(_FINISHED)
                    continue
                with self._cond:
                    self._pending.appendleft(seq)  # retry when blocks free up
                return
            seq.alloc = alloc
            if alloc.host_hits:
                # cached_tokens counts them as device KV: they land before
                # any compute touches the sequence
                self._inject_host_hits(alloc)
            if seq.joined_inflight:
                self.allocator.shared_prefill_tokens += alloc.cached_tokens
                seq.joined_inflight = False
            if seq.emitted == 0:  # preempted re-admissions are not new requests
                self.total_requests += 1
                self.total_prompt_tokens += len(seq.prompt)
            seq.slot = free[0]
            self._slots[seq.slot] = seq
            if seq.admit_t is None:
                seq.admit_t = time.perf_counter()
            # the last prompt token is never cached: >= 1 position computes
            seq.prefill_pos = seq.alloc.cached_tokens

    def _dispatch_step(self) -> None:
        active = [s for s in self._slots if s is not None]
        if not active:
            self._drain_inflight()
            return
        if any(s.prefill_pos is not None for s in active):
            # chunk prefill needs each decode lane's true last token host-side
            self._drain_inflight()
            self._chunk_step()
        elif self._spec_k > 0 and any(
            s.drafter is not None and s.drafter.would_draft() for s in active
        ):
            # every lane decodes and some drafter's index holds a usable
            # match: a verify dispatch (it drains the decode pipeline, so
            # lanes that cannot propose must not pay for it; it still falls
            # back to the pipelined decode step when no lane drafts)
            self._verify_step()
        else:
            self._decode_step()

    def _set_lane(self, i: int, seq: Optional[_Seq]) -> None:
        """Sampling vectors + block table of lane i (zeros for an idle lane)."""
        self._tables[i, :] = 0
        if seq is None:
            self._temp[i] = 0.0
            self._topk[i] = 0
            self._topp[i] = 1.0
            self._seeds[i] = 0
            self._freqp[i] = 0.0
            self._presp[i] = 0.0
            return
        self._tables[i, : len(seq.alloc.block_ids)] = seq.alloc.block_ids
        self._temp[i] = seq.temperature
        self._topk[i] = seq.top_k
        self._topp[i] = seq.top_p
        self._seeds[i] = seq.seed & 0x7FFFFFFF
        self._freqp[i] = seq.freq_pen
        self._presp[i] = seq.pres_pen

    def _chunk_step(self) -> None:
        """One [slots, prefill_chunk] dispatch: prefilling lanes consume up to
        a chunk of prompt; decode lanes advance one token."""
        cfg = self.config
        S, C = cfg.max_slots, cfg.prefill_chunk
        t_step = self._step_start()
        for seq in [s for s in self._slots if s is not None]:
            if seq.slot is None:
                continue  # preempted earlier in this pass
            if seq.ctx.context.is_stopped:
                self._finish(seq, FinishReason.CANCELLED)
            elif seq.prefill_pos is None:
                # a decode lane writes KV at position total_len-1
                need = min(seq.total_len, cfg.max_model_len)
                if not self.allocator.grow(seq.alloc, need):
                    self._preempt(seq)
        if self._timeline is not None:
            # the loop above is grow work: the allocator share of this
            # dispatch's host time
            self._prof_alloc_us += (time.perf_counter() - t_step) * 1e6
        if not any(self._slots):
            return

        tokens = np.zeros((S, C), np.int32)
        positions = np.full((S, C), -1, np.int32)
        sample_at = np.full((S,), -1, np.int32)
        consumed: List[Optional[List[int]]] = [None] * S
        for i in range(S):
            seq = self._slots[i]
            self._set_lane(i, seq)
            if seq is None:
                continue
            if seq.prefill_pos is not None:
                n = min(C, len(seq.prompt) - seq.prefill_pos)
                chunk_toks = seq.prompt[seq.prefill_pos : seq.prefill_pos + n]
                tokens[i, :n] = chunk_toks
                positions[i, :n] = np.arange(seq.prefill_pos, seq.prefill_pos + n)
                if seq.prefill_pos + n == len(seq.prompt):
                    sample_at[i] = n - 1
                consumed[i] = chunk_toks
            else:
                fed = seq.generated[-1] if seq.generated else seq.prompt[-1]
                tokens[i, 0] = fed
                positions[i, 0] = seq.total_len - 1
                sample_at[i] = 0
                consumed[i] = [fed]

        self._step_counter += 1
        self.chunk_dispatches += 1
        lanes = list(self._slots)
        # a wave whose lanes all start at position 0 attends nothing in the pool
        want_history = any(
            s is not None and (s.prefill_pos is None or s.prefill_pos > 0)
            for s in lanes
        )
        (want_lp, want_pen, want_sample), counts, wd = self._dispatch_args(lanes)
        args = (
            self._put(tokens), self._put(positions), self._put(self._tables),
            self._put(sample_at), self._step_counter, *self._sampling_args(), counts, *wd,
        )
        (sampled, lp, tids, tlps), timing = self._launch(
            self._chunk(want_lp, want_pen, want_sample, want_history), args)
        sampled_np = sampled.cpu().numpy()
        if want_lp:
            lp_np, tids_np, tlps_np = lp.cpu().numpy(), tids.cpu().numpy(), tlps.cpu().numpy()
        else:
            lp_np = tids_np = tlps_np = None
        if not want_pen:
            self._release_counts()

        for i in range(S):
            seq = self._slots[i]
            if seq is None or consumed[i] is None:
                continue
            self._alloc_timed(self.allocator.note_tokens_computed, seq.alloc, consumed[i])
            lpinfo = (
                (float(lp_np[i]), tids_np[i], tlps_np[i]) if lp_np is not None else None
            )
            tok = int(sampled_np[i])
            if self._watchdog and tok < 0:
                # the watchdog's sentinel, on a lane's first token or a
                # decode lane's next one: the stream ends in-band
                self._watchdog_trip(seq)
                continue
            if seq.prefill_pos is not None:
                seq.prefill_pos += len(consumed[i])
                if seq.prefill_pos >= len(seq.prompt):
                    seq.prefill_pos = None
                    seq.first_token_t = time.perf_counter()
                    if seq.emitted == 0:
                        self.recent_ttft_s.append(seq.first_token_t - seq.enqueue_t)
                    self._emit_token(seq, tok, lpinfo=lpinfo)
            else:
                self._emit_token(seq, tok, lpinfo=lpinfo)
        self._dispatch_done("chunk", t_step, timing, sum(1 for c in consumed if c is not None),
                            sum(len(c) for c in consumed if c))

    def _decode_step(self) -> None:
        """Pipelined decode: dispatch N+1 off dispatch N's device carry, then
        fetch and process N. Blocks of sequences that finish while a
        dispatch is in flight may still receive its writes, so their
        allocations park in ``_zombie_allocs`` until it is fetched."""
        cfg = self.config
        S, k = cfg.max_slots, cfg.decode_steps
        t_step = self._step_start()

        stopped = [s for s in self._slots if s is not None and s.ctx.context.is_stopped]
        if stopped:
            self._drain_inflight()
            for seq in stopped:
                if seq.slot is not None:
                    self._finish(seq, FinishReason.CANCELLED)

        # capacity: this dispatch writes total_len-1 .. total_len-2+k, and
        # the next (speculative) one another k past that
        t_grow = time.perf_counter() if self._timeline is not None else 0.0
        while True:
            ok = True
            for seq in [s for s in self._slots if s is not None]:
                need = min(seq.total_len - 1 + 2 * k, cfg.max_model_len)
                if not self.allocator.grow(seq.alloc, need):
                    if self._inflight is not None or self._zombie_allocs:
                        self._drain_inflight()  # releases zombie blocks
                    else:
                        self._preempt(seq)
                    ok = False
                    break
            if ok:
                break
        if self._timeline is not None:
            # grow/preempt work: the allocator share of this dispatch's
            # host time
            self._prof_alloc_us += (time.perf_counter() - t_grow) * 1e6
        if not any(self._slots):
            return

        lanes = list(self._slots)
        if self._inflight is not None and any(
            a is not b for a, b in zip(self._inflight.lanes, lanes)
        ):
            # the lane set changed: the in-flight carry no longer matches
            self._drain_inflight()
            lanes = list(self._slots)
            if not any(lanes):
                return

        def lane_needs_more(seq: _Seq) -> bool:
            ahead = k if (
                self._inflight is not None
                and seq.slot is not None
                and self._inflight.lanes[seq.slot] is seq
            ) else 0
            if seq.emitted + ahead >= seq.max_tokens:
                return False
            return seq.total_len + ahead < cfg.max_model_len

        # every lane provably stops within the in-flight dispatch: another
        # dispatch would only compute garbage the next wave queues behind
        if not any(lane_needs_more(s) for s in lanes if s is not None):
            self._drain_inflight()
            return

        for i in range(S):
            seq = self._slots[i]
            self._set_lane(i, seq)
            if seq is None:
                self._positions[i] = -1
                self._last_tokens[i] = 0
                continue
            self._positions[i] = seq.total_len - 1
            self._last_tokens[i] = seq.generated[-1] if seq.generated else seq.prompt[-1]

        if self._inflight is not None:
            toks_in, pos_in = self._inflight.tokens, self._inflight.positions
        else:
            toks_in = self._put(self._last_tokens)
            pos_in = self._put(self._positions)

        self._step_counter += 1
        self.decode_dispatches += 1
        self.decode_steps_total += k
        (want_lp, want_pen, want_sample), counts, wd = self._dispatch_args(lanes)
        args = (
            toks_in, pos_in, self._put(self._tables), self._step_counter,
            *self._sampling_args(), counts, *wd,
        )
        (out, lps, tids, tlps, toks2, pos2), timing = self._launch(
            self._decode(want_lp, want_pen, want_sample), args)
        if not want_pen:
            self._release_counts()
        fetch = lambda t: None if t is None else _HostFetch(t)  # noqa: E731
        prev, self._inflight = self._inflight, _Inflight(
            fetch(out), fetch(lps), fetch(tids), fetch(tlps), toks2, pos2, lanes
        )
        if prev is not None:
            self._process_chunk(prev, defer_free=True)
        n_active = sum(1 for s in lanes if s is not None)
        self._dispatch_done("decode", t_step, timing, n_active, n_active * k)

    def _verify_step(self) -> None:
        """One speculative-verify dispatch (the JAX ``_verify_step``).

        Drafts each decode lane from its n-gram index, feeds ``[last_token,
        draft_0..]`` through the verify function (one weight stream for all
        K1 positions) and emits the longest drafted prefix matching the
        sampled targets plus the first non-matching target. Not pipelined:
        the next dispatch's inputs depend on this one's acceptance. When no
        lane drafts, the plain pipelined decode step runs instead."""
        cfg = self.config
        S = cfg.max_slots
        t_step = self._step_start()
        # the host needs every lane's true last token and the drafters the
        # emitted suffix before proposing
        self._drain_inflight()
        for seq in [s for s in self._slots if s is not None and s.ctx.context.is_stopped]:
            self._finish(seq, FinishReason.CANCELLED)
        if not any(self._slots):
            return

        drafts: List[Optional[List[int]]] = [None] * S
        n_drafted = 0
        for i, seq in enumerate(self._slots):
            if seq is None or seq.drafter is None:
                continue
            # fed positions stay under max_model_len, and drafts past the
            # request's remaining budget are dead weight
            cap = min(self._spec_k, cfg.max_model_len - seq.total_len,
                      seq.max_tokens - seq.emitted)
            if cap <= 0:
                continue
            d = seq.drafter.draft()
            if d:
                drafts[i] = d[:cap]
                n_drafted += len(drafts[i])
        if n_drafted == 0:
            self._decode_step()
            return

        # room for the drafted positions (not pipelined: a preemption here
        # has no in-flight dispatch to wait for)
        for i, seq in enumerate(self._slots):
            if seq is None:
                continue
            need = min(seq.total_len + len(drafts[i] or []), cfg.max_model_len)
            if not self.allocator.grow(seq.alloc, need):
                drafts[i] = None
                self._preempt(seq)
        if not any(self._slots):
            return
        if not any(drafts[i] for i in range(S) if self._slots[i] is not None):
            self._decode_step()
            return

        k1 = self._spec_k + 1
        tokens = np.zeros((S, k1), np.int32)
        positions = np.full((S, k1), -1, np.int32)
        for i in range(S):
            seq = self._slots[i]
            self._set_lane(i, seq)
            if seq is None:
                continue
            fed = [seq.generated[-1] if seq.generated else seq.prompt[-1]]
            fed += drafts[i] or []
            n = len(fed)
            tokens[i, :n] = fed
            positions[i, :n] = np.arange(seq.total_len - 1, seq.total_len - 1 + n)

        self._step_counter += 1
        self.verify_dispatches += 1
        lanes = list(self._slots)
        (want_lp, want_pen, want_sample), counts, wd = self._dispatch_args(lanes)
        args = (
            self._put(tokens), self._put(positions), self._put(self._tables),
            self._step_counter, *self._sampling_args(), counts, *wd,
        )
        (tgt, lps, tids, tlps), timing = self._launch(
            self._verify(want_lp, want_pen, want_sample), args)
        tgt_np = tgt.cpu().numpy()
        if want_lp:
            lp_np, tids_np, tlps_np = lps.cpu().numpy(), tids.cpu().numpy(), tlps.cpu().numpy()
        else:
            lp_np = tids_np = tlps_np = None
        if not want_pen:
            self._release_counts()

        if self._perf is not None:
            tokens_before = self.total_generated_tokens
            self._perf.note_slots(sum(1 for s in self._slots if s is not None), S)
        drafted_total = accepted_total = 0
        fix_rows: List[int] = []
        fix_toks: List[int] = []
        for i in range(S):
            seq = self._slots[i]
            if seq is None:
                continue
            d = drafts[i] or []
            row = tgt_np[i]
            a = 0
            while a < len(d) and int(row[a]) == d[a]:
                a += 1
            if d:
                seq.drafter.note_result(len(d), a)
                seq.spec_drafted += len(d)
                seq.spec_accepted += a
                drafted_total += len(d)
                accepted_total += a
            penalized = seq.penalized
            # the matched drafts + the bonus target, cut as a decode run is
            n_emitted = self._emit_token_run(
                seq, [int(t) for t in row[: a + 1]],
                (lp_np[i], tids_np[i], tlps_np[i]) if lp_np is not None else None,
            )
            self.verify_tokens += n_emitted
            if want_pen and penalized:
                # the targets loop added EVERY active position's target to
                # this lane's count row: subtract the ones not emitted
                # (rejected positions, and any cut by max_tokens / EOS)
                for j in range(n_emitted, 1 + len(d)):
                    if row[j] >= 0:
                        fix_rows.append(i)
                        fix_toks.append(int(row[j]))
        if fix_rows and self._counts is not None:
            rows = torch.tensor(fix_rows, dtype=torch.int64, device=self.device)
            toks = torch.tensor(fix_toks, dtype=torch.int64, device=self.device)
            self._counts.index_put_(
                (rows, toks), torch.full_like(rows, -1, dtype=torch.int32), accumulate=True
            )
        self.spec_drafted_total += drafted_total
        self.spec_accepted_total += accepted_total
        if self._perf is not None:
            self._perf.note_decode(self.total_generated_tokens - tokens_before, 1)
            self._perf.note_spec(drafted_total, accepted_total)
        # lanes still live after the emits (the JAX engine's count)
        n_lanes = sum(1 for s in self._slots if s is not None)
        self._dispatch_done("verify", t_step, timing, n_lanes, accepted_total + n_lanes)

    def _emit_token_run(self, seq: _Seq, cand: List[int], lp_rows, *,
                        defer_free: bool = False) -> int:
        """Emit one multi-token run for a lane: cut at max_tokens /
        max_model_len / first EOS, register the fed tokens' KV, emit ONE
        item, and finish the lane on a terminal cut. Returns the number of
        tokens emitted. A run holding the watchdog's sentinel emits and
        seals nothing: the lane ends in-band (:meth:`_watchdog_trip`)."""
        if self._watchdog and any(t < 0 for t in cand):
            self._watchdog_trip(seq, defer_free=defer_free)
            return 0
        cfg = self.config
        n_take = min(len(cand), seq.max_tokens - seq.emitted, cfg.max_model_len - seq.total_len)
        finish: Optional[FinishReason] = None
        if n_take < len(cand):
            finish = FinishReason.LENGTH
        toks = cand[:n_take]
        if seq.eos_ids and not seq.ignore_eos:
            for j, t in enumerate(toks):
                if t in seq.eos_ids:
                    toks = toks[: j + 1]
                    finish = FinishReason.EOS
                    break
        if not toks:
            if finish is not None:
                self._finish(seq, finish, defer_free=defer_free)
            return 0
        if finish is None and seq.emitted + len(toks) >= seq.max_tokens:
            finish = FinishReason.LENGTH
        elif finish is None and seq.total_len + len(toks) >= cfg.max_model_len:
            finish = FinishReason.LENGTH
        # fed tokens whose KV is valid and part of the sequence
        fed0 = seq.generated[-1] if seq.generated else seq.prompt[-1]
        self._alloc_timed(self.allocator.note_tokens_computed, seq.alloc, [fed0] + toks[:-1])

        log_probs = top_logprobs = None
        if lp_rows is not None and seq.logprobs is not None:
            lps_row, tids_row, tlps_row = lp_rows
            n = len(toks)
            log_probs = [float(x) for x in lps_row[:n]]
            if seq.logprobs > 0:
                kk = min(seq.logprobs, tids_row.shape[1])
                top_logprobs = [
                    {int(tids_row[j, p]): float(tlps_row[j, p]) for p in range(kk)}
                    for j in range(n)
                ]
        seq.generated.extend(toks)
        seq.out_tokens.extend(toks)
        if seq.drafter is not None:
            seq.drafter.extend(toks)
        seq.emitted += len(toks)
        self.total_generated_tokens += len(toks)
        seq.emit(Annotated.from_data(
            LLMEngineOutput(
                token_ids=toks, log_probs=log_probs, top_logprobs=top_logprobs
            ).to_dict(),
            id=seq.ctx.id,
        ))
        if finish is not None:
            self._finish(seq, finish, defer_free=defer_free)
        return len(toks)

    def _process_chunk(self, chunk: _Inflight, defer_free: bool) -> None:
        if self._perf is not None:
            # gap between consecutive processed dispatches ≈ a dispatch's
            # wall time in pipelined decode; tokens counted below feed the
            # tps EMA
            tokens_before = self.total_generated_tokens
            self._perf.note_slots(
                sum(1 for s in chunk.lanes if s is not None), self.config.max_slots,
            )
        out = chunk.out.get()  # [S, k_steps]
        if chunk.lps is not None:
            lps, tids, tlps = chunk.lps.get(), chunk.top_ids.get(), chunk.top_lps.get()
        else:
            lps = tids = tlps = None
        for i, seq in enumerate(chunk.lanes):
            if seq is None or seq.slot != i:
                continue  # empty lane, or finished in an earlier dispatch
            self._emit_token_run(
                seq, [int(t) for t in out[i]],
                (lps[i], tids[i], tlps[i]) if lps is not None else None,
                defer_free=defer_free,
            )
        if self._perf is not None:
            self._perf.note_decode(
                self.total_generated_tokens - tokens_before, self.config.decode_steps,
            )

    def _drain_inflight(self) -> None:
        """Fetch + process any in-flight dispatch, then release zombie blocks."""
        if self._inflight is not None:
            chunk, self._inflight = self._inflight, None
            self._process_chunk(chunk, defer_free=False)
        for alloc in self._zombie_allocs:
            self.allocator.free_sequence(alloc)
        self._zombie_allocs.clear()

    def _emit_token(self, seq: _Seq, tok: int, defer_free: bool = False, lpinfo=None) -> None:
        seq.generated.append(tok)
        seq.out_tokens.append(tok)
        if seq.drafter is not None:
            seq.drafter.extend((tok,))
        seq.emitted += 1
        self.total_generated_tokens += 1
        finish: Optional[FinishReason] = None
        if tok in seq.eos_ids and not seq.ignore_eos:
            finish = FinishReason.EOS
        elif seq.emitted >= seq.max_tokens:
            finish = FinishReason.LENGTH
        elif seq.total_len >= self.config.max_model_len:
            finish = FinishReason.LENGTH
        log_probs = top_logprobs = None
        if seq.logprobs is not None and lpinfo is not None:
            chosen_lp, top_ids, top_lps = lpinfo
            log_probs = [chosen_lp]
            if seq.logprobs > 0:
                kk = min(seq.logprobs, len(top_ids))
                top_logprobs = [{int(top_ids[p]): float(top_lps[p]) for p in range(kk)}]
        seq.emit(Annotated.from_data(
            LLMEngineOutput(
                token_ids=[tok], log_probs=log_probs, top_logprobs=top_logprobs
            ).to_dict(),
            id=seq.ctx.id,
        ))
        if finish is not None:
            self._finish(seq, finish, defer_free=defer_free)

    def _release_lane(self, seq: _Seq, defer_free: bool) -> None:
        """Free a finished sequence's slot and pages."""
        if seq.slot is not None:
            self._slots[seq.slot] = None
            seq.slot = None
        if seq.alloc is not None:
            if defer_free:
                # the in-flight dispatch may still write into these blocks
                self._zombie_allocs.append(seq.alloc)
            else:
                self.allocator.free_sequence(seq.alloc)
            seq.alloc = None

    def _record_phase_spans(self, seq: _Seq, reason: FinishReason) -> None:
        """Retroactive phase spans from the timestamps the hot path already
        stamps (engine thread, once per request: dispatch loops stay
        allocation-free), as the JAX engine records them. queue_wait =
        enqueue → slot admission; prefill = admission → first token;
        decode = first token → finish, with the token count."""
        now = time.perf_counter()
        parent = seq.ctx.context.trace
        status = tracing.STATUS_OK
        if reason == FinishReason.CANCELLED:
            status = "cancelled"
        elif reason == FinishReason.ERROR:
            status = "error"
        req_span = tracing.record_span(
            "engine.request", seq.enqueue_t, now, parent=parent,
            attributes={
                "request_id": seq.ctx.id,
                "prompt_tokens": len(seq.prompt),
                "output_tokens": seq.emitted,
                # no disaggregated prefill in the port (yet): every prefill
                # is local
                "remote_prefill": False,
                "finish_reason": str(getattr(reason, "value", reason)),
            },
            status=status,
        )
        parent = req_span or parent
        first = seq.first_token_t
        prefill_start = seq.enqueue_t
        if seq.admit_t is not None and (first is None or seq.admit_t <= first):
            prefill_start = seq.admit_t
        tracing.record_span(
            "engine.queue_wait", seq.enqueue_t, prefill_start,
            parent=parent, phase="queue_wait",
        )
        if first is not None:
            tracing.record_span(
                "engine.prefill", prefill_start, first, parent=parent, phase="prefill",
            )
            decode_attrs: Dict[str, Any] = {"tokens": seq.emitted}
            if seq.spec_drafted:
                # per-request speculation outcome on the decode span, and
                # the acceptance rate (0..1) on the spec_accept histogram
                decode_attrs["spec_drafted"] = seq.spec_drafted
                decode_attrs["spec_accepted"] = seq.spec_accepted
                tracing.observe_phase("spec_accept", seq.spec_accepted / seq.spec_drafted)
            tracing.record_span(
                "engine.decode", first, now, parent=parent, phase="decode",
                attributes=decode_attrs,
            )

    def _finish(self, seq: _Seq, reason: FinishReason, defer_free: bool = False) -> None:
        if tracing.enabled():
            self._record_phase_spans(seq, reason)
        self._release_lane(seq, defer_free)
        seq.emit(Annotated.from_data(LLMEngineOutput.final(reason).to_dict(), id=seq.ctx.id))
        seq.emit(_FINISHED)

    def _preempt(self, seq: _Seq) -> None:
        """Out of KV blocks: recompute-preempt — free the pages and requeue
        with prompt := prompt + generated (the prefix cache softens the
        recompute); ``emitted`` keeps the caller-visible count."""
        logger.warning("preempting request %s (out of KV blocks)", seq.ctx.id)
        self.preemptions += 1
        if seq.slot is not None:
            self._slots[seq.slot] = None
            seq.slot = None
        self.allocator.free_sequence(seq.alloc)
        seq.prompt = seq.prompt + seq.generated
        seq.generated = []
        seq.alloc = None
        seq.prefill_pos = None
        with self._cond:
            self._pending.append(seq)

    # -- KV pages in and out of the pool ---------------------------------------

    def inject_blocks(self, block_ids: List[int], k, v, k_scale=None, v_scale=None) -> None:
        """Write KV pages into the pool at the given physical pages, in place
        (engine thread only): ``k``/``v`` [L, n, bs, KVH, D] and, for an int8
        pool, ``k_scale``/``v_scale`` [L, n, bs], as host or device tensors
        or numpy arrays; on a mesh KVH is the global count, in global head
        order, and each rank takes its slice. A layout that disagrees with
        the pool (scales with a native pool, none with an int8 one) or a
        shape that does not fit raises before any byte lands."""
        if self.kv_quantized != (k_scale is not None):
            raise KvDtypeMismatch(
                "pool kv_dtype is %s but injected pages %s scale tables" % (
                    "int8" if self.kv_quantized else "native",
                    "lack" if k_scale is None else "carry",
                )
            )
        vals = {"k": k, "v": v}
        if k_scale is not None:
            vals.update(k_scale=k_scale, v_scale=v_scale)
        vals = {n: torch.as_tensor(x) for n, x in vals.items()}
        n = len(block_ids)
        tp = len(self._rank_pools)
        for name, x in vals.items():
            dst = self._rank_pools[0][name]
            want = (dst.shape[0], n) + tuple(dst.shape[2:])
            if tp > 1:  # the global pool's heads
                want = want[:3] + (want[3] * tp,) + want[4:]
            if tuple(x.shape) != want:
                raise ValueError(f"inject_blocks: {name} is {tuple(x.shape)}, the pool takes "
                                 f"{want} for {n} pages")
        # the checksums of pages sealed before must copy them out first
        self._flush_crcs()
        for name, x in vals.items():
            # global head order: rank r takes its contiguous slice of kv heads
            parts = x.chunk(tp, dim=3) if tp > 1 else (x,)
            for pool, part in zip(self._rank_pools, parts):
                dst = pool[name]
                idx = torch.tensor(block_ids, dtype=torch.int64, device=dst.device)
                dst[:, idx] = part.to(dst.device, dst.dtype)

    def _offload_blocks(self, pairs: List[Tuple[int, int, Any]]) -> None:
        """Spill evicted device blocks to the host tier without waiting for
        the copy (the allocator calls this inside admission and decode
        growth, engine thread only). The gather into fresh device buffers is
        enqueued on the engine's stream before any later dispatch can
        overwrite the freed pages; the copy into pinned host memory follows
        on the same stream behind an event, and :meth:`_harvest_spills`
        moves it into the host pool once the event has passed. ``pairs``
        are ``(hash, block_id, crc)``; ``crc`` is the block's seal checksum
        (an int, a future of one, or None with the integrity plane off). On
        the CPU the gather is the copy and there is no event."""
        bufs = self._gather_pages([bid for _, bid, _ in pairs])
        event = None
        if self.device.type == "cuda":
            host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in bufs]
            for h, b in zip(host, bufs):
                h.copy_(b, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            bufs = host
        if not self.kv_quantized:
            bufs += [None, None]
        self._pending_spills.append((pairs, *bufs, event))

    def _harvest_spills(self, force: bool = False) -> None:
        """Move finished spills into the host pool (engine thread), oldest
        first, stopping at the first whose copy is still running; ``force``
        (an idle engine, or more than ``MAX_PENDING_SPILLS`` pending) waits
        for every one. Each block is stored as a copy of its slice, never a
        view that would pin the whole spill, with its seal checksum: a spill
        whose checksums are still being computed waits like one whose copy
        is still running (they were started before its copy, on the same
        stream). The ``corrupt`` fault flips a byte of a spill's k pages
        here (bad host RAM), after its checksum was taken."""
        self._flush_crcs()
        if not self._pending_spills:
            return
        if len(self._pending_spills) > MAX_PENDING_SPILLS:
            force = True
        while self._pending_spills:
            pairs, k, v, ks, vs, event = self._pending_spills[0]
            if not force and (
                (event is not None and not event.query())
                or any(isinstance(crc, Future) and not crc.done() for _, _, crc in pairs)
            ):
                return
            if event is not None:
                event.synchronize()
            self._pending_spills.popleft()
            if faults_mod.current() is not None:
                k = faults_mod.corrupt_array("engine", self._fault_addr, k)
            for i, (h, _, crc) in enumerate(pairs):
                self.host_pool.put(
                    h, k[:, i].clone(), v[:, i].clone(),
                    ks[:, i].clone() if ks is not None else None,
                    vs[:, i].clone() if vs is not None else None,
                    crc=resolve_crc(crc),
                )

    def _inject_host_hits(self, alloc: SequenceAllocation) -> None:
        """Write a new sequence's host-tier prefix hits (content captured by
        the allocator at probe time) into its pages; an int8 pool's scales
        come along."""
        hits = alloc.host_hits
        block_ids = [alloc.block_ids[h[0]] for h in hits]
        k = torch.stack([h[2] for h in hits], dim=1)
        v = torch.stack([h[3] for h in hits], dim=1)
        ks = vs = None
        if hits[0][4] is not None:
            ks = torch.stack([h[4] for h in hits], dim=1)
            vs = torch.stack([h[5] for h in hits], dim=1)
        alloc.host_hits = []
        self.inject_blocks(block_ids, k, v, ks, vs)

    # -- metrics ----------------------------------------------------------------

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Load and KV gauges (the ForwardPassMetrics fields the router
        reads) plus the engine's dispatch counters and the paged decode
        kernel's launch count; with the telemetry plane on (the default)
        the live decode gauges, with ``DYN_TPU_PROFILE`` the timeline's
        decode split and device idle fraction, with ``DYN_TPU_STRAGGLER``
        the fail-slow gauges and this worker's latched verdict, as the JAX
        engine reports them."""
        with self._cond:
            probe = max(self.allocator.probe_tokens, 1)
            m = {
                "request_active_slots": sum(1 for s in self._slots if s is not None),
                "request_total_slots": self.config.max_slots,
                "kv_active_blocks": self.allocator.active_blocks,
                "kv_total_blocks": self.num_blocks,
                "kv_free_blocks": self.allocator.free_blocks,
                "kv_reclaimable_blocks": self.allocator.reclaimable_blocks,
                "num_requests_waiting": len(self._pending),
                "gpu_cache_usage_perc": self.allocator.usage(),
                "gpu_prefix_cache_hit_rate": self.allocator.hit_tokens / probe,
                "inflight_prefill_waits": self.allocator.inflight_waits,
                "shared_prefill_tokens": self.allocator.shared_prefill_tokens,
                "kv_peak_occupancy_perc": round(self.allocator.peak_occupancy(), 4),
                "preemptions": self.preemptions,
                "chunk_dispatches": self.chunk_dispatches,
                "decode_dispatches": self.decode_dispatches,
                "decode_steps_total": self.decode_steps_total,
                "paged_decode_launches": paged_decode_attention.launches,
                "paged_decode_int8_launches": paged_decode_attention_int8.launches,
                "paged_decode_sharded_launches": paged_decode_attention_sharded.launches,
                "tensor_parallel_size": self.mesh.tp if self.mesh is not None else 1,
                "kv_quantized": int(self.kv_quantized),
                # speculative decoding: cumulative draft counters (the
                # acceptance-rate EMA is the telemetry plane's)
                "spec_drafted_tokens": self.spec_drafted_total,
                "spec_accepted_tokens": self.spec_accepted_total,
                "verify_dispatches": self.verify_dispatches,
                # integrity plane: this engine's output-watchdog trips (the
                # process-global trip and quarantine counters are
                # runtime/integrity.py's counters())
                "watchdog_trips": self.watchdog_trips,
                **({"host_cache_blocks": len(self.host_pool),
                    "host_cache_hits": self.host_pool.hits}
                   if self.host_pool is not None else {}),
            }
        if self._perf is not None:
            m["decode_tokens_per_s"] = round(self._perf.decode_tps, 3)
            m["step_time_ms"] = round(self._perf.step_time_ms, 3)
            m["batch_slot_util"] = round(self._perf.slot_util, 4)
            m["spec_accept_rate"] = round(self._perf.spec_accept_rate, 4)
        if self._timeline is not None:
            # decode-phase device/host p95 split + device idle fraction,
            # from the process-global dispatch timeline
            m.update(self._timeline.gauges())
            m["dispatch_gate_timeouts"] = self._device_timer.timeouts
        if self._straggler is not None:
            # normalized per-token latency + sample freshness, and this
            # worker's latched verdict
            m.update(self._straggler.gauges())
            m["straggler_state"] = straggler_mod.verdict()
        return m


class _DeviceScope:
    """``torch.no_grad`` plus, on CUDA, the engine's device as current."""

    def __init__(self, device: torch.device):
        self._device = device
        self._ng = torch.no_grad()

    def __enter__(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        self._ng.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ng.__exit__(*exc)


def build_torch_serving_engine(
    card,
    max_batch_size: int = 8,
    kv_block_size: int = 16,
    max_model_len: Optional[int] = None,
    num_kv_blocks: Optional[int] = None,
    seed: int = 0,
    event_sink: Optional[KvEventSink] = None,
    decode_steps: int = 4,
    device: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    quantize: Optional[str] = None,
    kv_dtype: Optional[str] = None,
    host_cache_blocks: int = 0,
    tensor_parallel_size: int = 1,
    devices: Optional[List[str]] = None,
) -> TorchServingEngine:
    """CLI entry: model + engine from a ModelDeploymentCard, on CUDA unless
    ``device="cpu"``. ``quantize``, ``kv_dtype`` and ``host_cache_blocks``
    are :class:`EngineConfig`'s (``kv_dtype=None`` reads
    ``DYN_TPU_KV_DTYPE``); with
    ``"int8-all"`` the weights are quantized as they are loaded (or drawn),
    so the bf16 tree never exists on the device: how a model too large for
    the card in bf16 (mixtral-8x7b, llama3-70b) is served. ``num_kv_blocks``
    (default: ``EngineConfig``'s rule from the slots and the context) sizes
    the pool, per rank on a mesh.

    ``tensor_parallel_size`` > 1 serves over a tp mesh (``build_jax_serving_engine``'s
    argument): its ranks on ``devices`` (default ``cuda:0 … cuda:N-1``,
    fewer cards raise; a list may name one device more than once to
    co-locate ranks, and ``device="cpu"`` puts every rank on the CPU). The
    weights are sliced to their ranks as they are read or drawn."""
    from .weights import config_from_card, load_params

    mesh = None
    if tensor_parallel_size > 1 or devices is not None:
        if devices is None and device is not None and torch.device(device).type == "cpu":
            devices = ["cpu"] * tensor_parallel_size
        mesh = make_mesh(MeshConfig(tp=tensor_parallel_size), devices)
        dev = mesh.devices[0]
    else:
        dev = resolve_device(device)
    model_config = config_from_card(card, dtype=dtype)
    if mesh is not None:
        rank_config(model_config, mesh.tp)  # raises before any weight is read
    params = load_params(card, model_config, seed=seed, device=dev,
                         int8=quantize == "int8-all", mesh=mesh)
    engine_config = EngineConfig(
        max_slots=max_batch_size,
        kv_block_size=kv_block_size,
        max_model_len=max_model_len or min(card.context_length, 4096),
        num_kv_blocks=num_kv_blocks,
        decode_steps=decode_steps,
        quantize=quantize,
        kv_dtype=kv_dtype,
        host_cache_blocks=host_cache_blocks,
    )
    return TorchServingEngine(
        model_config, params, engine_config, device=dev, event_sink=event_sink, mesh=mesh,
    )
