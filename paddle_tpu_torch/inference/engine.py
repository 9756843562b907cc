"""Continuous-batching serving engine (port of
``paddle_tpu/inference/engine.py``, the single-device engine).

Orca-style iteration-level scheduling (Yu et al., OSDI '22) over the vLLM
paged KV cache (Kwon et al., SOSP '23). Each ``step()``:
  1. sheds queued requests past their deadline, then admits waiting
     requests while the free-block budget covers their prompt (plus one
     decode block of headroom), sharing cached prefix blocks when the
     prefix cache is on;
  2. runs one prefill chunk for the oldest admitted prompt, allocating its
     blocks lazily per chunk (shrinking the chunk's live span to the
     pool's headroom before it evicts anyone);
  3. runs one decode batch over all RUNNING sequences, padded to a batch
     bucket, allocating each sequence's next block as it crosses a block
     boundary and PREEMPTING-BY-EVICTION (lowest priority, then the
     best-cached, then youngest, back to the front of the waiting queue,
     blocks released, recompute on readmission) when the pool runs dry.

The scheduling decisions, the event log, the journal records and the
metric exposition are the JAX engine's, so a deterministic replay gives
the same token streams, events, outcomes and Prometheus bytes. Greedy
decoding; the argmax and the non-finite screen run on the device and only
[B] values come back to the host per step.

Overload and fault contract:

  - ``submit()`` returns an :class:`Admission`: a bounded waiting queue, a
    token-bucket rate limit and a free-block-aware overcommit estimate
    each give a deterministic ``rejected`` outcome with a cause.
  - Requests carry optional TTFT/total deadlines and a priority; queued
    requests past a deadline are shed (engine-clock arithmetic only, so
    shedding replays identically).
  - A request whose prefill raises a :class:`PoisonError` or an injected
    fault, or whose logits go non-finite, is QUARANTINED: blocks
    released, failed with a cause, the decode batch re-driven without it.
    An exception from a CUDA launch or sync is never quarantined: it
    propagates, and ``run()`` leaves a leak-free pool behind it.
  - With a journal path every accepted request and emitted token goes to
    a crash-recoverable JSONL journal (inference/journal.py); a fresh
    engine's :meth:`InferenceEngine.recover` re-drives to the same
    streams.

Every request ends in exactly one terminal state, finished, rejected,
shed or failed, with a cause (:meth:`outcomes`).

Prefix cache (``ServeConfig(prefix_cache=True)``): full prompt blocks
stay indexed by their exact token prefix after release; a later prompt
with the same prefix shares them ref-counted and prefills from the end of
the hit. Every write into a block another sequence holds first copies it
(:meth:`InferenceEngine._cow_span`).

int8 paged KV (``ServeConfig(kv_dtype="int8")``): the pools hold int8
codes with f32 scale pools, one scale per block, kv-head and column,
written once per column by ``kv_quant_columns``. The draft pools of
speculative decoding keep the model dtype.

Speculative decoding (``ServeConfig(speculative=True)``): a draft model
(default: the base truncated to its first layer,
:func:`~paddle_tpu_torch.models.llama.make_draft_model`) proposes up to
``draft_k`` tokens per row through host-chained decode steps on its own
pools, which share the base block tables; then ONE batched verify step
scores all K+1 positions and commits only the accepted prefix's KV.
Every emitted token is the base model's greedy argmax, so streams equal
sequential decode for any draft.

Tensor-parallel serving (``ServeConfig(mp=n)``, n > 1): one process a
rank, each building its own engine over its own shards. The weights are
sliced by ``param_pspecs`` over mp (q/k/v/gate/up by column, o/down by
row, embed and lm_head by vocabulary) and every pool (the model-dtype or
int8 pools, their scales and the draft pools) holds the rank's NKV/n kv
heads. Block ids, tables, the free list, the prefix-cache index, COW
spans and the commit schedule stay rank-agnostic host state, and every
rank takes the same decision at every iteration: the steps gather
full-vocab logits on every rank before any argmax or finite screen, each
iteration of ``run()`` starts from rank 0's clock and any rank's stop
flag (one all-reduce), and only rank 0 writes the journal, which every
rank reads in ``recover()``. The mp group comes from
``HybridCommunicateGroup(mp_degree=n)`` over the process group that
``init_parallel_env`` made (nccl, a card a rank, by default; gloo by
name); without one of n ranks the engine raises ValueError. An error on
one rank leaves its peers in a collective until the group's timeout.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import signal
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import envs
from .._device import resolve_device
from ..distributed import communication as comm
from ..distributed.checkpoint import save_load as sl
from ..distributed.checkpoint.manager import _STEP_RE, CheckpointManager
from ..distributed.fleet import HybridCommunicateGroup
from ..distributed.layout import split_dims
from ..models.llama import (LlamaConfig, _tensor_from_numpy,
                            init_paged_kv_pool, init_paged_kv_scales,
                            llama_paged_decode_step,
                            llama_paged_prefill_chunk,
                            llama_paged_verify_step, make_draft_model,
                            serving_pspecs, shard_for_serving)
from ..observability.flight_recorder import (FlightRecorder,
                                             flight_recorder_enabled)
from ..observability.histogram import LogHistogram
from ..observability.metrics import StepMetrics
from ..observability.registry import MetricsRegistry
from ..observability.request_trace import RequestTracer
from ..observability.trace import comm_span, record_counter
from ..testing import faults
from .journal import EngineJournal, JournalCompatError, read_journal
from .kv_cache import (BlockPool, PrefixCache, pad_table,
                       pool_bytes_per_rank)

ENV_TRACE_REQUESTS = "PADDLE_TPU_TORCH_TRACE_REQUESTS"
ENV_SERVE_MAX_QUEUE = "PADDLE_TPU_TORCH_SERVE_MAX_QUEUE"
ENV_SERVE_RATE = "PADDLE_TPU_TORCH_SERVE_RATE"
ENV_SERVE_BURST = "PADDLE_TPU_TORCH_SERVE_BURST"
ENV_SERVE_OVERCOMMIT = "PADDLE_TPU_TORCH_SERVE_OVERCOMMIT"
ENV_SERVE_NAN_CHECK = "PADDLE_TPU_TORCH_SERVE_NAN_CHECK"
ENV_SERVE_JOURNAL = "PADDLE_TPU_TORCH_SERVE_JOURNAL"
ENV_SERVE_JOURNAL_FSYNC = "PADDLE_TPU_TORCH_SERVE_JOURNAL_FSYNC"
ENV_SERVE_PREFIX_CACHE = "PADDLE_TPU_TORCH_SERVE_PREFIX_CACHE"
ENV_SERVE_KV_DTYPE = "PADDLE_TPU_TORCH_SERVE_KV_DTYPE"
ENV_SERVE_SPEC = "PADDLE_TPU_TORCH_SERVE_SPEC"
ENV_SERVE_SPEC_K = "PADDLE_TPU_TORCH_SERVE_SPEC_K"
ENV_SERVE_MP = "PADDLE_TPU_TORCH_SERVE_MP"

WAITING, PREFILL, RUNNING, FINISHED = "waiting", "prefill", "running", \
    "finished"
SHED, FAILED = "shed", "failed"

class PoisonError(RuntimeError):
    """A poisoned per-request computation, attributable to ``rid``.
    Raised by the engine's own non-finite logit screens, and usable from a
    fault-injection corrupt callable to simulate a request whose device
    computation raises (``PoisonError(ctx['rids'][0])``)."""

    def __init__(self, rid: int, cause: str = "poisoned request"):
        super().__init__(f"request {rid}: {cause}")
        self.rid = rid
        self.cause = cause


# what a request's own prefill may raise and be quarantined for; anything
# else (a CUDA launch or sync error above all) propagates
_QUARANTINABLE = (PoisonError, faults.FaultError)


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is seconds from engine start
    (wall mode) or the iteration index (deterministic replay mode).
    ``ttft_deadline``/``deadline`` are engine-clock spans from arrival
    (first token / full completion); a queued request past its deadline
    is shed. Higher ``priority`` survives eviction longer."""
    prompt: Sequence[int]
    max_new_tokens: int = 16
    request_id: Optional[int] = None
    eos_id: Optional[int] = None
    arrival: float = 0.0
    priority: int = 0
    ttft_deadline: Optional[float] = None
    deadline: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Admission:
    """The ``submit()`` outcome: accepted into the bounded queue, or
    rejected with a deterministic cause (``queue_full`` | ``overcommit``
    | ``rate_limit`` | ``draining``)."""
    accepted: bool
    request_id: int
    cause: Optional[str] = None


class _TokenBucket:
    """``rate`` admissions per engine-clock unit, capacity ``burst``.
    Refill arithmetic uses the ENGINE clock (iteration index in
    deterministic replay), never wall time, so admission decisions replay
    identically."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._level = float(burst)
        self._at = 0.0

    def take(self, now: float) -> bool:
        if now > self._at:
            self._level = min(self.burst,
                              self._level + (now - self._at) * self.rate)
            self._at = now
        if self._level < 1.0:
            return False
        self._level -= 1.0
        return True


class AdmissionController:
    """Explicit admit/reject decision at ``submit()``.

    Three valves, checked in order (first hit wins): ``queue_full``
    (bounded waiting queue), ``overcommit`` (the worst-case block demand
    of everything queued+active plus this request exceeds ``overcommit``
    x the usable pool) and ``rate_limit`` (token bucket; checked last so
    requests rejected anyway do not drain the bucket)."""

    def __init__(self, max_queue: int, rate: Optional[float],
                 burst: float, overcommit: float):
        self.max_queue = int(max_queue)
        self.overcommit = float(overcommit)
        self.bucket = _TokenBucket(rate, burst) if rate else None

    def decide(self, queue_len: int, demand_blocks: int,
               worst_blocks: int, usable_blocks: int,
               now: float) -> Optional[str]:
        """None to accept, else the rejection cause."""
        if queue_len >= self.max_queue:
            return "queue_full"
        if demand_blocks + worst_blocks > self.overcommit * usable_blocks:
            return "overcommit"
        if self.bucket is not None and not self.bucket.take(now):
            return "rate_limit"
        return None


@dataclasses.dataclass
class ServeConfig:
    block_size: int = 128
    num_blocks: int = 64          # includes the reserved null block 0
    max_batch: int = 8
    prefill_chunk: int = 64
    max_seq_len: int = 1024       # bounds the block-table width
    decode_buckets: Optional[Tuple[int, ...]] = None
    # overload valves; None defers to the PADDLE_TPU_TORCH_SERVE_* knob,
    # which in turn falls back to the documented default
    max_queue: Optional[int] = None       # default 4 x max_batch
    rate_limit: Optional[float] = None    # admissions/clock-unit; 0=off
    burst: Optional[int] = None           # default max(2, max_batch)
    overcommit: Optional[float] = None    # default 4.0 x usable blocks
    nan_check: Optional[bool] = None      # default True
    # capacity features; None defers to the knob (defaults: no sharing,
    # model-dtype KV, no speculation, 4 proposals per row)
    prefix_cache: Optional[bool] = None   # COW shared prefix blocks
    kv_dtype: Optional[str] = None        # "auto" (model dtype) | "int8"
    speculative: Optional[bool] = None    # draft + batched verification
    draft_k: Optional[int] = None         # proposals/seq/iteration (>=1)
    # tensor-parallel degree, one process a rank; None defers to the
    # knob (default 1, one card)
    mp: Optional[int] = None

    def __post_init__(self):
        if self.decode_buckets is None:
            b, buckets = 1, []
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            self.decode_buckets = tuple(buckets) + (self.max_batch,)
        self.decode_buckets = tuple(sorted(set(self.decode_buckets)))
        if self.decode_buckets[-1] != self.max_batch:
            raise ValueError("largest decode bucket must equal max_batch")
        if self.draft_k is not None and self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if self.kv_dtype is not None and self.kv_dtype not in ("auto",
                                                               "int8"):
            raise ValueError(f"ServeConfig.kv_dtype must be 'auto' or "
                             f"'int8', got {self.kv_dtype!r}")

    @property
    def max_nb(self) -> int:
        return -(-self.max_seq_len // self.block_size)


class _Seq:
    """Scheduler-side sequence state. Invariant while RUNNING:
    n_cached == len(tokens) - 1, and the next decode feeds tokens[-1] at
    position n_cached."""

    def __init__(self, req: Request, now: float):
        self.req = req
        self.tokens: List[int] = [int(t) for t in req.prompt]
        self.n_prompt = len(self.tokens)
        self.n_cached = 0
        self.blocks: List[int] = []
        self.state = WAITING
        self.arrival = now
        self.order = 0                 # submission sequence number
        self.first_token_t: Optional[float] = None
        self.token_times: List[float] = []
        self.n_preempted = 0
        self.fail_cause: Optional[str] = None   # shed/quarantine cause
        self.recovered = False                  # rebuilt from a journal
        # tokens whose KV the DRAFT pools hold; always <= n_cached after
        # a verify (rejected lookahead KV is simply re-proposed over)
        self.draft_pos = 0

    @property
    def generated(self) -> List[int]:
        return self.tokens[self.n_prompt:]

    @property
    def prefill_target(self) -> int:
        # fresh prompts cache every prompt token and sample from the final
        # chunk's logits; a preempted sequence re-caches all but its newest
        # (never-fed) token and resumes decoding instead
        return len(self.tokens) - (1 if self.generated else 0)

    def done(self) -> bool:
        g = self.generated
        return (len(g) >= self.req.max_new_tokens
                or (self.req.eos_id is not None and g
                    and g[-1] == self.req.eos_id))


def _knob(value, name):
    """An explicit ServeConfig field, else its knob."""
    return value if value is not None else envs.get(name)


# the mp group of each process group, made once: new_group is collective
_MP_GROUPS: Dict[Tuple[int, int], Tuple[Any, comm.Group]] = {}


def serving_group(mp: int) -> comm.Group:
    """The mp group of a tensor-parallel engine of ``mp`` ranks:
    ``HybridCommunicateGroup(mp_degree=mp)``'s, over the process group
    ``init_parallel_env`` made, which must hold exactly ``mp`` ranks
    (else ValueError). Made once a process group and reused by every
    engine after."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if world != mp:
        raise ValueError(
            f"ServeConfig.mp={mp} needs a process group of {mp} ranks, one "
            f"process a rank: call paddle_tpu_torch.distributed."
            f"init_parallel_env in each of {mp} processes first (this "
            f"process is {'one of ' + str(world) if up else 'in no group'})")
    key = (id(dist.group.WORLD), mp)
    if key not in _MP_GROUPS:
        _MP_GROUPS[key] = (dist.group.WORLD, HybridCommunicateGroup(
            mp_degree=mp).get_model_parallel_group())
    return _MP_GROUPS[key][1]


def _weight_dicts(tree) -> bool:
    """Whether a param tree holds an int8 or transposed weight dict."""
    leaves = list(tree.get("layers", {}).values()) + [tree.get("lm_head")]
    return any(isinstance(w, dict) for w in leaves)


class InferenceEngine:
    """Continuous-batching engine over a paged KV cache.

    >>> eng = InferenceEngine(params, config, ServeConfig())
    >>> stats = eng.run([Request(prompt, max_new_tokens=32), ...])

    ``device`` defaults to the card; ``params`` must already live there.
    With speculation on, ``draft_params``/``draft_config`` name the draft
    model (default: :func:`make_draft_model`). Drive it from a single
    thread. At ``mp`` > 1 every rank builds its engine from the FULL
    params (and draft params) and keeps its shards; ``device`` is the
    rank's."""

    def __init__(self, params: Dict[str, Any], config: LlamaConfig,
                 serve: Optional[ServeConfig] = None,
                 telemetry: Optional[StepMetrics] = None,
                 record_events: bool = False,
                 trace_requests: Optional[bool] = None,
                 flight_recorder: Optional[bool] = None,
                 journal: Optional[str] = None,
                 draft_params: Optional[Dict[str, Any]] = None,
                 draft_config: Optional[LlamaConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.config = config
        self.serve = sv = serve or ServeConfig()
        self.mp = int(_knob(sv.mp, ENV_SERVE_MP))
        if self.mp < 1:
            raise ValueError(f"ServeConfig.mp must be >= 1, got {self.mp}")
        self.speculative = bool(_knob(sv.speculative, ENV_SERVE_SPEC))
        if self.speculative and draft_params is None:
            draft_params, draft_config = make_draft_model(params, config)
        elif self.speculative and draft_config is None:
            raise ValueError("draft_params given without draft_config")
        # tensor parallelism: the mp group and this rank's weight shards;
        # None and the full weights at mp 1
        self.tp: Optional[comm.Group] = None
        self._tp_specs = None
        if self.mp > 1:
            params, draft_params = self._shard_tp(params, draft_params,
                                                  draft_config)
        self.params = params
        self.pool = BlockPool(sv.num_blocks, sv.block_size)
        self.kv_dtype = _knob(sv.kv_dtype, ENV_SERVE_KV_DTYPE)
        self.k_pool, self.v_pool = init_paged_kv_pool(
            config, sv.num_blocks, sv.block_size, kv_dtype=self.kv_dtype,
            device=self.device, mp=self.mp)
        # int8 KV: the scale pools, passed through every base-model step
        self.k_scale = self.v_scale = None
        if self.kv_dtype == "int8":
            self.k_scale, self.v_scale = init_paged_kv_scales(
                config, sv.num_blocks, sv.block_size, device=self.device,
                mp=self.mp)
        # COW prefix cache: full prompt blocks stay indexed after release
        # and later identical prompts share them ref-counted
        self.cache: Optional[PrefixCache] = (
            PrefixCache(self.pool)
            if _knob(sv.prefix_cache, ENV_SERVE_PREFIX_CACHE) else None)
        self._cow_copies = 0
        self.draft_k = int(_knob(sv.draft_k, ENV_SERVE_SPEC_K))
        self.draft_params = self.draft_config = None
        self.k_draft = self.v_draft = None
        self._spec_proposed = 0
        self._spec_accepted = 0
        self.draft_steps = 0
        self._draft_s = 0.0
        if self.speculative:
            self.draft_params, self.draft_config = draft_params, draft_config
            # the draft pools mirror the base pool's block geometry (one
            # shared block table per sequence) in the model dtype, int8 KV
            # or not: draft KV shapes proposals only, never output bytes
            self.k_draft, self.v_draft = init_paged_kv_pool(
                draft_config, sv.num_blocks, sv.block_size,
                device=self.device, mp=self.mp)
        self.metrics = telemetry
        self.record_events = record_events
        # request-lifecycle tracing is measurement only: spans take
        # timestamps the scheduler already crosses and never feed back
        if trace_requests is None:
            trace_requests = envs.get(ENV_TRACE_REQUESTS)
        self.tracer: Optional[RequestTracer] = \
            RequestTracer() if trace_requests else None
        self.recorder: Optional[FlightRecorder] = (
            FlightRecorder(source="engine")
            if flight_recorder_enabled(flight_recorder) else None)
        # streaming SLO histograms, always on; values in the ENGINE clock
        # (seconds in wall mode, iterations in deterministic mode)
        self.slo: Dict[str, LogHistogram] = {
            "ttft": LogHistogram(), "tpot": LogHistogram(),
            "queue_wait": LogHistogram()}
        self.events: List[Tuple] = []
        self.waiting: List[_Seq] = []
        self.active: List[_Seq] = []      # PREFILL + RUNNING, FCFS order
        self.finished: List[_Seq] = []
        self.rejected: List[Tuple[Request, str]] = []
        self.shed: List[_Seq] = []
        self.failed: List[_Seq] = []
        self.iteration = 0
        self.preemptions = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self._decode_s = 0.0
        self._prefill_s = 0.0
        self._last_tokens = 0
        self._redrives = 0
        self._recovered = 0
        self._jtoks: List[Tuple[int, int]] = []  # this iteration's tokens
        # one exposition: the SLO histograms register by reference, the
        # scheduler gauges as render-time callbacks; the registration
        # order IS the metrics_snapshot() key order
        self.registry = MetricsRegistry(prefix="paddle_tpu_serve")
        self._register_metrics()
        max_queue = (sv.max_queue if sv.max_queue is not None
                     else envs.get(ENV_SERVE_MAX_QUEUE) or 4 * sv.max_batch)
        rate = _knob(sv.rate_limit, ENV_SERVE_RATE)
        burst = (sv.burst if sv.burst is not None
                 else envs.get(ENV_SERVE_BURST) or max(2, sv.max_batch))
        overcommit = _knob(sv.overcommit, ENV_SERVE_OVERCOMMIT)
        self.admission = AdmissionController(max_queue, rate, burst,
                                             overcommit)
        self._nan_check = _knob(sv.nan_check, ENV_SERVE_NAN_CHECK)
        self.journal_path = (journal if journal is not None
                             else envs.get(ENV_SERVE_JOURNAL)) or None
        self._journal: Optional[EngineJournal] = None
        if self.journal_path and self._writes_journal:
            self._journal = EngineJournal(
                self.journal_path,
                fsync=envs.get(ENV_SERVE_JOURNAL_FSYNC),
                meta=self._journal_meta())
        self._rid = itertools.count()
        self._seqno = itertools.count()
        self._compiled: Dict[Tuple, float] = {}
        self._clock = 0.0
        # preemption and live weight push
        self._preempt = threading.Event()
        self._was_preempted = False
        self._signum: Optional[int] = None
        self._prev_handler: Any = None
        self._pending_swap: Optional[Tuple[Any, int]] = None
        self.swaps = 0
        self.last_swap: Optional[Dict[str, Any]] = None
        # drain mode: submit() rejects with cause 'draining' while the
        # accepted work runs to completion
        self._draining = False

    @property
    def _writes_journal(self) -> bool:
        """Only rank 0 of an mp group writes the journal; every rank
        reads it in :meth:`recover`."""
        return self.tp is None or self.tp.rank == 0

    def _shard_tp(self, params, draft_params, draft_config):
        """The JAX engine's ``_shard_tp`` for one rank: refuse what the
        contiguous head slicing cannot express (before any group is
        needed), take the mp group, and return this rank's shards of the
        base params and of the draft's (a default draft is remade as
        views of the base's shards, so a weight swap moves both)."""
        c, mp = self.config, self.mp
        for dim, name in ((c.num_attention_heads, "num_attention_heads"),
                          (c.num_key_value_heads, "num_key_value_heads"),
                          (c.vocab_size, "vocab_size"),
                          (c.intermediate_size, "intermediate_size")):
            if dim % mp:
                raise ValueError(
                    f"ServeConfig.mp={mp} needs {name} % mp == 0 "
                    f"(got {dim}): heads/vocab/ffn slice contiguously "
                    f"across ranks")
        if "qkv_proj" in params.get("layers", {}):
            raise ValueError(
                "tensor-parallel serving needs split q/k/v projections; "
                "fused qkv_proj weights interleave heads and cannot "
                "slice contiguously over 'mp'")
        if _weight_dicts(params) or (draft_params is not None
                                     and _weight_dicts(draft_params)):
            raise ValueError(
                "tensor-parallel serving takes plain weight tensors; "
                "int8/transposed weight dicts don't carry the "
                "param_pspecs tree")
        self.tp = serving_group(mp)
        self._tp_specs = serving_pspecs(c, mp)
        default_draft = (draft_params is not None
                         and draft_params["embed"] is params["embed"])
        shards = shard_for_serving(params, c, self.tp)
        if draft_params is not None:
            draft_params = (
                make_draft_model(shards, c,
                                 draft_config.num_hidden_layers)[0]
                if default_draft
                else shard_for_serving(draft_params, draft_config, self.tp))
        return shards, draft_params

    def _agree(self, stop: bool, clock: float) -> Tuple[bool, float]:
        """Rank 0's clock and any rank's stop flag, on every rank of the
        mp group: one all-reduce of two f64 values (the other ranks add
        exact zeros to rank 0's clock)."""
        t = torch.tensor([clock if self.tp.rank == 0 else 0.0, float(stop)],
                         dtype=torch.float64, device=self.device)
        clock, stop = comm.all_reduce(t, self.tp).tolist()
        return stop > 0, clock

    def _register_metrics(self) -> None:
        """Register every engine metric into the registry: the live SLO
        histograms by reference and the scheduler gauges as callbacks read
        at render time, all host-side ``len()``s and counters, so scraping
        never touches the device."""
        r = self.registry
        r.summary("ttft_seconds", hist=self.slo["ttft"],
                  help="time to first token (engine clock)")
        r.summary("tpot_seconds", hist=self.slo["tpot"],
                  help="time per output token (engine clock)")
        r.summary("queue_wait_seconds", hist=self.slo["queue_wait"],
                  help="submit-to-first-schedule wait (engine clock)")
        r.gauge("queue_depth", fn=lambda: len(self.waiting),
                help="requests admitted but not yet scheduled")
        r.gauge("running", fn=lambda: sum(1 for s in self.active
                                          if s.state == RUNNING),
                help="sequences in decode")
        r.gauge("prefilling", fn=lambda: sum(1 for s in self.active
                                             if s.state == PREFILL),
                help="sequences in chunked prefill")
        r.gauge("batch_capacity", fn=lambda: self.serve.max_batch,
                help="configured max decode batch")
        r.gauge("pool_utilization", fn=lambda: self.pool.utilization,
                help="fraction of KV blocks in use")
        r.gauge("iterations", fn=lambda: self.iteration,
                help="scheduler iterations run")
        r.gauge("preemptions", fn=lambda: self.preemptions,
                help="sequences evicted for memory pressure")
        r.gauge("finished_requests", fn=lambda: len(self.finished),
                help="requests completed")
        r.gauge("rejected_requests", fn=lambda: len(self.rejected),
                help="requests refused at admission")
        r.gauge("shed_requests", fn=lambda: len(self.shed),
                help="requests shed past their deadline")
        r.gauge("failed_requests", fn=lambda: len(self.failed),
                help="requests quarantined or failed")
        r.gauge("decode_redrives", fn=lambda: self._redrives,
                help="decode steps re-driven during journal recovery")
        r.gauge("generated_tokens",
                fn=lambda: sum(len(s.generated) for s in self.finished),
                help="tokens generated by finished requests")
        # capacity gauges only when the cache is live, so the default
        # exposition keeps its shape
        if self.cache is not None:
            r.gauge("prefix_cache_hits", fn=lambda: self.cache.hits,
                    help="admissions served a shared prefix from the "
                         "cache")
            r.gauge("prefix_cache_hit_tokens",
                    fn=lambda: self.cache.hit_tokens,
                    help="prompt tokens whose prefill was skipped via "
                         "cache")
            r.gauge("prefix_cached_blocks",
                    fn=lambda: self.pool.cached_blocks,
                    help="parked prefix-cache blocks (zero refs, "
                         "reclaimable)")
            r.gauge("cow_copies", fn=lambda: self._cow_copies,
                    help="shared blocks copied on write")
        if self.speculative:
            r.gauge("spec_proposed_tokens", fn=lambda: self._spec_proposed,
                    help="draft tokens proposed for verification")
            r.gauge("spec_accepted_tokens", fn=lambda: self._spec_accepted,
                    help="draft tokens the base model accepted")
            r.gauge("spec_accept_rate",
                    fn=lambda: (self._spec_accepted / self._spec_proposed
                                if self._spec_proposed else 0.0),
                    help="accepted / proposed draft tokens")

    # -- bookkeeping --------------------------------------------------------

    def _journal_meta(self) -> Dict[str, Any]:
        """Audit-only open-record fields: which capacity features were
        live. Cache STATE is derived (bytes are a pure function of the
        token prefix), so recovery never needs it journaled."""
        return {"kv_dtype": self.kv_dtype,
                "prefix_cache": self.cache is not None,
                "speculative": self.speculative,
                "mp": self.mp}

    def _event(self, *ev):
        if self.record_events:
            self.events.append((self.iteration,) + tuple(ev))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One host->device copy through pinned memory on the card."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _alloc_for(self, seq: _Seq, n_tokens: int) -> bool:
        """Grow ``seq`` to cover ``n_tokens`` cached tokens; False (and no
        change) when the pool is dry."""
        need = self.pool.blocks_for(n_tokens) - len(seq.blocks)
        if need <= 0:
            return True
        got = self.pool.alloc(need)
        if got is None:
            return False
        seq.blocks.extend(got)
        record_counter("serve.blocks_alloc", need)
        return True

    def _release(self, seq: _Seq):
        if seq.blocks:
            record_counter("serve.blocks_free", len(seq.blocks))
            self.pool.free(seq.blocks)
            seq.blocks = []

    def _cow_span(self, seq: _Seq, start: int, n_tokens: int) -> bool:
        """Copy-on-write guard: make every block covering positions
        [start, start+n) privately writable before the device writes. A
        block with other readers is copied (a device copy of its slabs in
        the base, scale and draft pools, then a table swap); a registered
        ref-1 block has its index entry invalidated instead. With sharing
        on, scheduler writes land past the hit span by construction, so
        this is a defensive invariant, but it is THE contract that keeps
        shared bytes immutable. False if the pool cannot supply a copy
        block (the caller evicts or stalls)."""
        if self.cache is None or n_tokens < 1:
            return True
        bs = self.pool.block_size
        for bi in range(start // bs, (start + n_tokens - 1) // bs + 1):
            if bi >= len(seq.blocks):
                continue
            b = seq.blocks[bi]
            if self.pool.ref_count(b) > 1:
                got = self.pool.alloc(1)
                if got is None:
                    return False
                nb = got[0]
                for pool in (self.k_pool, self.v_pool, self.k_scale,
                             self.v_scale, self.k_draft, self.v_draft):
                    if pool is not None:
                        # the draft pools share the block table, so their
                        # slabs move with the base's copy
                        pool[:, nb] = pool[:, b]
                self.pool.free([b])
                seq.blocks[bi] = nb
                self._cow_copies += 1
                record_counter("serve.cow_copy")
                self._event("cow_copy", seq.req.request_id, b, nb)
            elif self.pool.is_registered(b):
                # sole owner, but the index still maps a prefix to this
                # block: writing would corrupt future hits' bytes, so the
                # entry is forgotten and the block stays private
                self.cache.invalidate_block(b)
        return True

    def _evict_one(self, protect: Optional[_Seq] = None) -> bool:
        """Preempt the lowest-priority, then best-cached, then YOUNGEST
        running sequence: free its blocks and push it to the FRONT of the
        waiting queue for recompute-style readmission (its generated
        tokens are kept; the KV prefix is re-prefilled)."""
        victims = [s for s in self.active
                   if s.state == RUNNING and s is not protect]
        if not victims:
            return False

        def restorable(s: _Seq) -> int:
            # blocks backing prefix-cache entries survive this eviction
            # (they park or stay shared), so readmission re-hits them:
            # the most-cached victim costs the least recompute. Zero for
            # every sequence when the cache is off.
            if self.cache is None:
                return 0
            return sum(1 for b in s.blocks if self.pool.is_registered(b))

        victim = max(victims,
                     key=lambda s: (-s.req.priority, restorable(s),
                                    s.arrival, s.order))
        self.active.remove(victim)
        self._release(victim)
        victim.state = WAITING
        victim.n_cached = 0
        victim.draft_pos = 0
        victim.n_preempted += 1
        self.waiting.insert(0, victim)
        self.preemptions += 1
        record_counter("serve.preempt")
        self._event("evict", victim.req.request_id)
        if self.tracer is not None:
            self.tracer.evict(victim.req.request_id, time.perf_counter(),
                              victim.n_preempted)
        if self.recorder is not None:
            self.recorder.note_eviction(self.iteration)
        return True

    def _finish_seq(self, seq: _Seq, t: float):
        seq.state = FINISHED
        if seq in self.active:
            self.active.remove(seq)
        self._release(seq)
        self.finished.append(seq)
        record_counter("serve.finish")
        if self.tracer is not None:
            self.tracer.finish(seq.req.request_id, t, len(seq.generated))

    def _record_terminal(self, event: str, rid: int, cause: str):
        """A reject/shed/quarantine's trail in the flight recorder and the
        journal (a quarantine is journaled as ``failed``)."""
        if self.recorder is not None:
            self.recorder.record({"iteration": self.iteration,
                                  "event": event, "rid": rid,
                                  "cause": cause})
        if self._journal is not None:
            {"reject": self._journal.reject, "shed": self._journal.shed,
             "quarantine": self._journal.failed}[event](rid, cause)

    def _shed_seq(self, seq: _Seq, cause: str):
        """Terminal shed of a QUEUED sequence (deadline already missed)."""
        self._release(seq)
        seq.state = SHED
        seq.fail_cause = cause
        self.shed.append(seq)
        record_counter("serve.shed")
        self._event("shed", seq.req.request_id, cause)
        if self.tracer is not None:
            self.tracer.shed(seq.req.request_id, time.perf_counter(),
                             cause)
        self._record_terminal("shed", seq.req.request_id, cause)

    def _shed_expired(self):
        """Deadline-based load shedding over the waiting queue: a queued
        request past its TTFT or total deadline can no longer meet it, so
        it is shed now instead of burning pool blocks. Pure engine-clock
        arithmetic, so replays shed identically."""
        if not self.waiting:
            return
        kept = []
        for seq in self.waiting:
            r, waited = seq.req, self._clock - seq.arrival
            if r.deadline is not None and waited > r.deadline:
                self._shed_seq(seq, "deadline")
            elif (r.ttft_deadline is not None and not seq.generated
                    and waited > r.ttft_deadline):
                self._shed_seq(seq, "ttft_deadline")
            else:
                kept.append(seq)
        self.waiting = kept

    def _quarantine(self, seq: _Seq, cause: str):
        """Poisoned request: release its blocks, mark it failed with the
        cause, keep serving everyone else."""
        if seq in self.active:
            self.active.remove(seq)
        self._release(seq)
        seq.state = FAILED
        seq.fail_cause = cause
        self.failed.append(seq)
        record_counter("serve.quarantine")
        self._event("quarantine", seq.req.request_id, cause)
        if self.tracer is not None:
            self.tracer.quarantine(seq.req.request_id,
                                   time.perf_counter(), cause)
        self._record_terminal("quarantine", seq.req.request_id, cause)

    def _pools_alive(self) -> bool:
        """False when the card's context died under the pools: a sticky
        CUDA error, after which every launch fails and nothing in-process
        can recover (the journal recovery path owns that failure). The
        pools are written in place, never donated, so nothing else can
        invalidate them. Called only on the exception path: it syncs."""
        if self.device.type != "cuda":
            return True
        try:
            torch.cuda.synchronize(self.device)
        except RuntimeError:
            return False
        return True

    def _mark_compiled(self, kind: str, key, t_call: float):
        """The first call of each step shape (on the card it also takes
        the kernels' first-use build and the libraries' warm-up)."""
        if (kind, key) not in self._compiled:
            self._compiled[(kind, key)] = t_call
            record_counter(f"serve.compile.{kind}")
            if self.metrics is not None:
                self.metrics.record_compile(compile_s=t_call)
            if self.recorder is not None:
                self.recorder.record_compile(f"{kind}_{key}", t_call)

    # -- public API ---------------------------------------------------------

    def _demand_and_shared(self, req: Optional[Request]
                           ) -> Tuple[int, int]:
        """Worst-case block demand of everything queued + active, and the
        new request's estimated prefix-shared blocks.

        With the prefix cache on, shared prefix blocks are free by
        construction (N requests over one cached prefix cost its blocks
        ONCE), so each request's worst case shrinks by its expected hit
        length. Queued-but-unprefilled prompts count too (``pending``
        keys), so a same-instant burst of identical prompts is admitted
        against one copy of the shared span. Cache off: the plain sum."""
        demand = 0
        cache = self.cache
        pending: set = set()
        for s in itertools.chain(self.waiting, self.active):
            # speculative lookahead needs no extra headroom: the cap
            # t_cap <= max_new - generated keeps every allocation within
            # blocks_for(prompt + max_new)
            worst = self.pool.blocks_for(
                len(s.req.prompt) + s.req.max_new_tokens)
            if cache is not None:
                limit = (len(s.req.prompt) - 1) // self.pool.block_size
                shared = cache.match_len(s.req.prompt, limit, pending)
                worst -= min(shared, worst - 1)
                pending.update(cache.prospective_keys(s.req.prompt,
                                                      limit))
            demand += worst
        new_shared = 0
        if req is not None and cache is not None:
            limit = (len(req.prompt) - 1) // self.pool.block_size
            new_shared = cache.match_len(req.prompt, limit, pending)
        return demand, new_shared

    def _demand_blocks(self) -> int:
        """Worst-case block demand of everything queued + active."""
        return self._demand_and_shared(None)[0]

    def submit(self, req: Request) -> Admission:
        """Admit ``req`` into the bounded queue or reject it with a
        deterministic cause. Malformed requests (that can never be served
        at any load) raise ValueError; overload is an Admission outcome,
        not an exception."""
        if req.request_id is None:
            req.request_id = next(self._rid)
        worst = len(req.prompt) + req.max_new_tokens
        if worst > self.serve.max_seq_len:
            raise ValueError(
                f"request {req.request_id}: prompt+max_new_tokens {worst} "
                f"exceeds max_seq_len {self.serve.max_seq_len}")
        if self.pool.blocks_for(worst) > self.serve.num_blocks - 1:
            raise ValueError(
                f"request {req.request_id} can never fit the pool "
                f"({worst} tokens > {self.serve.num_blocks - 1} blocks)")
        if not len(req.prompt):
            raise ValueError(f"request {req.request_id}: empty prompt")
        faults.inject("serve.admit.before", rid=req.request_id)
        if self._draining:
            # a draining engine admits nothing new; checked before the
            # valves so draining never spends bucket tokens
            cause = "draining"
        else:
            demand, new_shared = self._demand_and_shared(req)
            worst_blocks = max(self.pool.blocks_for(worst) - new_shared, 1)
            cause = self.admission.decide(
                queue_len=len(self.waiting),
                demand_blocks=demand,
                worst_blocks=worst_blocks,
                usable_blocks=self.serve.num_blocks - 1,
                now=self._clock)
        if cause is not None:
            self.rejected.append((req, cause))
            record_counter("serve.reject")
            self._event("reject", req.request_id, cause)
            if self.tracer is not None:
                self.tracer.reject(req.request_id, time.perf_counter(),
                                   cause)
            self._record_terminal("reject", req.request_id, cause)
            return Admission(False, req.request_id, cause)
        seq = _Seq(req, self._clock)
        seq.order = next(self._seqno)
        self.waiting.append(seq)
        self._event("submit", req.request_id)
        if self.tracer is not None:
            self.tracer.submit(req.request_id, time.perf_counter())
        if self._journal is not None:
            self._journal.submit(req)
        faults.inject("serve.admit.after", rid=req.request_id)
        return Admission(True, req.request_id)

    def adopt(self, req: Request, generated: Sequence[int] = ()) -> None:
        """Adopt an already-ACCEPTED request migrated from another engine:
        enqueue it BYPASSING the admission valves (accepted work is never
        re-rejected) with its already-emitted tokens attached, exactly as
        ``recover()`` rebuilds an unfinished rid. Greedy decode is
        deterministic in (prompt + history), so the continuation equals
        the donor's would-have-been stream. The request is re-journaled on
        THIS engine, so a second crash recovers from this journal
        alone."""
        if req.request_id is None:
            req.request_id = next(self._rid)
        seq = _Seq(req, self._clock)
        seq.order = next(self._seqno)
        seq.tokens.extend(int(t) for t in generated)
        seq.recovered = True
        if seq.generated:
            # its first token predates this engine: never re-measure TTFT
            seq.first_token_t = seq.arrival
        if self._journal is not None:
            self._journal.submit(req)
            if seq.generated:
                self._journal.tokens(
                    self.iteration,
                    [(req.request_id, t) for t in seq.generated])
        if seq.done():
            # the donor emitted its last token but never journaled the
            # finish mark: already complete, no re-drive
            seq.state = FINISHED
            self.finished.append(seq)
            if self._journal is not None:
                self._journal.finish(req.request_id)
        else:
            self.waiting.append(seq)
        self._recovered += 1
        record_counter("serve.adopt")
        self._event("adopt", req.request_id, len(seq.generated))

    def load_signal(self) -> Tuple[float, float, float]:
        """Composite load for routing, host-side and cheap: (queue depth +
        in-flight, -available blocks, streaming TTFT p99). Every component
        is a pure function of scheduler state and the engine clock."""
        p99 = self.slo["ttft"].percentile(99)
        return (float(len(self.waiting) + len(self.active)),
                -float(self.pool.available_blocks),
                float(p99 if p99 is not None else 0.0))

    def step(self) -> List[_Seq]:
        """One scheduler iteration: shed, admit, one prefill chunk, one
        decode batch. Returns sequences that finished this iteration."""
        # the gap between step() calls is the engine's safe boundary: the
        # previous step already synced its tokens to the host, so a
        # scheduled weight swap lands exactly here
        if self._pending_swap is not None \
                and self.iteration + 1 >= self._pending_swap[1]:
            source, _ = self._pending_swap
            self._pending_swap = None
            self._apply_swap(source)
        self.iteration += 1
        self._last_tokens = 0
        self._jtoks = []
        t_iter = time.perf_counter()
        if faults.fires("serve.preempt_storm"):
            # injected pool-pressure fault: evict the youngest running
            # sequence, as if a burst had stolen its blocks
            self._evict_one()
        self._shed_expired()
        self._admit()
        t_adm = time.perf_counter()
        done: List[_Seq] = []
        ran_prefill = self._prefill_chunk(done)
        t_pre = time.perf_counter()
        done += self._decode_batch()
        t_dec = time.perf_counter()
        for seq in done:
            self._event("finish", seq.req.request_id, len(seq.generated))
        if self._journal is not None:
            # one tokens record per iteration; finish marks AFTER it so a
            # torn tail can lose a finish mark but never a finished
            # request's tokens (recover() re-derives the mark)
            self._journal.tokens(self.iteration, self._jtoks)
            for seq in done:
                self._journal.finish(seq.req.request_id)
        if self.tracer is not None:
            self.tracer.phase("admit", t_iter, t_adm, self.iteration)
            if ran_prefill:
                self.tracer.phase("prefill", t_adm, t_pre, self.iteration)
            self.tracer.phase("decode", t_pre, t_dec, self.iteration)
        if self.metrics is not None or self.recorder is not None:
            n_run = n_pre = 0
            for s in self.active:
                if s.state == RUNNING:
                    n_run += 1
                elif s.state == PREFILL:
                    n_pre += 1
            fields = dict(
                step_time_s=t_dec - t_iter,
                tokens=self._last_tokens,
                queue_depth=len(self.waiting),
                n_running=n_run,
                n_prefill=n_pre,
                batch_occupancy=n_run / self.serve.max_batch,
                pool_utilization=self.pool.utilization,
                prefill_ms=(t_pre - t_adm) * 1e3 if ran_prefill else 0.0,
                decode_ms=(t_dec - t_pre) * 1e3,
            )
            if self.metrics is not None:
                self.metrics.step(**fields)
            if self.recorder is not None:
                self.recorder.record({"iteration": self.iteration, **fields})
                self.recorder.check_step_time(t_dec - t_iter)
        return done

    def idle(self) -> bool:
        return not self.waiting and not self.active

    def _base_step(self, fn, *args):
        """One base-model step ``fn`` over the engine's pools (and, with
        int8 KV, its scale pools); stores the returned pools and returns
        what comes before them."""
        if self.k_scale is None:
            *res, self.k_pool, self.v_pool = fn(*args, tp=self.tp)
        else:
            *res, self.k_pool, self.v_pool, self.k_scale, self.v_scale = fn(
                *args, kv_scales=(self.k_scale, self.v_scale), tp=self.tp)
        return res[0] if len(res) == 1 else res

    # -- scheduler phases ---------------------------------------------------

    def _admit(self):
        while self.waiting and len(self.active) < self.serve.max_batch:
            seq = self.waiting[0]
            # prefix-cache hit: the longest chain of cached full blocks
            # prefixing this prompt, capped one token short of
            # prefill_target so the final chunk always has a live token to
            # produce the sampling logits. Hit blocks are shared
            # ref-counted (COW), never re-prefilled.
            hit: List[int] = []
            if self.cache is not None and not seq.blocks:
                limit = (seq.prefill_target - 1) // self.pool.block_size
                hit = self.cache.match(seq.tokens, limit)
            need = self.pool.blocks_for(seq.prefill_target) + 1 - len(hit)
            if not self.pool.can_alloc(need):
                break
            self.waiting.pop(0)
            seq.state = PREFILL
            if hit:
                self.pool.acquire(hit)
                seq.blocks = list(hit)
                seq.n_cached = len(hit) * self.pool.block_size
                record_counter("serve.prefix_hit")
                record_counter("serve.prefix_hit_tokens", seq.n_cached)
                self._event("prefix_hit", seq.req.request_id, len(hit))
            else:
                seq.n_cached = 0
            self.active.append(seq)
            record_counter("serve.admit")
            self._event("admit", seq.req.request_id)
            if not seq.generated:
                # first admission: queue wait from submit to here
                self.slo["queue_wait"].record(self._clock - seq.arrival)
            if self.tracer is not None:
                self.tracer.admit(seq.req.request_id, time.perf_counter(),
                                  seq.n_preempted)

    def _prefill_chunk(self, done_out: Optional[List[_Seq]] = None) -> bool:
        seq = next((s for s in self.active if s.state == PREFILL), None)
        if seq is None:
            return False
        rid = seq.req.request_id
        faults.inject("serve.prefill.before", rid=rid)
        c = self.serve.prefill_chunk
        n_live = min(c, seq.prefill_target - seq.n_cached)
        # under pool pressure, shrink this chunk's live span to the
        # headroom the pool still has before resorting to eviction;
        # available_blocks counts parked cache blocks (alloc() reclaims
        # them after the free list)
        headroom = ((len(seq.blocks) + self.pool.available_blocks)
                    * self.pool.block_size - seq.n_cached)
        if 1 <= headroom < n_live:
            n_live = headroom
            record_counter("serve.prefill_shrink")
            self._event("prefill_shrink", rid, n_live)
        if not (self._alloc_for(seq, seq.n_cached + n_live)
                and self._cow_span(seq, seq.n_cached, n_live)):
            # pool dry mid-prompt: steal from the youngest decoder; if
            # there is none, stall (decode progress will free blocks)
            if not (self._evict_one(protect=seq)
                    and self._alloc_for(seq, seq.n_cached + n_live)
                    and self._cow_span(seq, seq.n_cached, n_live)):
                return False
        host = np.zeros((c + self.serve.max_nb,), np.int32)
        host[:n_live] = seq.tokens[seq.n_cached:seq.n_cached + n_live]
        host[c:] = pad_table(seq.blocks, self.serve.max_nb)
        t0 = time.perf_counter()
        try:
            faults.inject("serve.prefill.poison", rid=rid)
            with comm_span("serve.prefill", nbytes=int(n_live) * 4,
                           site="serve.prefill"):
                dev = self._to_device(host)
                logits = self._base_step(
                    llama_paged_prefill_chunk, self.params, self.k_pool,
                    self.v_pool, dev[c:], seq.n_cached, dev[:c], n_live,
                    self.config)
                # a corrupting fault writes into the device logits before
                # the on-device screen
                faults.inject("serve.prefill.logits", rid=rid,
                              logits=logits)
                tok, finite = torch.stack(
                    [logits.argmax(-1), torch.isfinite(logits).all().long()]
                ).tolist()
            if self._nan_check and not finite:
                raise PoisonError(rid, "non-finite prefill logits")
        except _QUARANTINABLE as e:
            if not self._pools_alive():
                raise
            # a prefill chunk touches exactly one request, so the failure
            # is attributable: quarantine it, keep serving
            cause = (e.cause if isinstance(e, PoisonError)
                     else f"prefill: {e!r}")
            self._quarantine(seq, cause)
            return True
        t1 = time.perf_counter()
        self._prefill_s += t1 - t0
        self.prefill_chunks += 1
        self._mark_compiled("prefill", c, t1 - t0)
        if self.tracer is not None:
            self.tracer.prefill_chunk(rid, t0, t1, int(n_live),
                                      recompute=bool(seq.generated))
        seq.n_cached += n_live
        if seq.n_cached == seq.prefill_target:
            if self.cache is not None:
                # register the prompt's FULL blocks, wholly below
                # prefill_target, so their bytes are immutable from here
                # on; a quarantined prefill never reaches this line
                n_reg = seq.prefill_target // self.pool.block_size
                if n_reg:
                    added = self.cache.register(seq.tokens, seq.blocks,
                                                n_reg)
                    if added:
                        self._event("prefix_register", rid, added)
            if not seq.generated:
                # fresh prompt: the final chunk's logits sample the first
                # new token (greedy)
                seq.tokens.append(int(tok))
                seq.first_token_t = self._now()
                seq.token_times.append(seq.first_token_t)
                self._last_tokens += 1
                self._jtoks.append((rid, seq.tokens[-1]))
                self.slo["ttft"].record(seq.first_token_t - seq.arrival)
            if seq.done():
                # eos/max_new on the very first token: finish here so
                # "done() implies finished" holds at every iteration
                # boundary (recover() relies on it)
                self._finish_seq(seq, time.perf_counter())
                if done_out is not None:
                    done_out.append(seq)
            else:
                seq.state = RUNNING
                if self.speculative:
                    # bring the draft's cache up to n_cached before the
                    # first decode iteration touches this row (fresh,
                    # readmitted, recovered and prefix-hit rows alike)
                    self._draft_prefill(seq)
        faults.inject("serve.prefill.after", rid=rid)
        return True

    def _draft_prefill(self, seq: _Seq):
        """Chunked prefill of ``seq``'s cached tokens through the DRAFT
        model into the draft pools (shared block table). Draft state is
        derived only: an evicted or recovered row re-prefills it."""
        c = self.serve.prefill_chunk
        table = self._to_device(pad_table(seq.blocks, self.serve.max_nb))
        start, target = 0, seq.n_cached
        t0 = time.perf_counter()
        while start < target:
            n_live = min(c, target - start)
            ids = np.zeros((c,), np.int32)
            ids[:n_live] = seq.tokens[start:start + n_live]
            _, self.k_draft, self.v_draft = llama_paged_prefill_chunk(
                self.draft_params, self.k_draft, self.v_draft, table, start,
                self._to_device(ids), n_live, self.draft_config, tp=self.tp)
            start += n_live
        t1 = time.perf_counter()
        self._mark_compiled("draft_prefill", c, t1 - t0)
        seq.draft_pos = target
        if self.tracer is not None:
            self.tracer.phase("draft", t0, t1, self.iteration)

    def _grow_rows(self, window) -> Tuple[List[_Seq], Dict[int, int]]:
        """Grow each RUNNING row to cover ``window(seq)`` new positions
        (blocks allocated and made private), evicting when the pool runs
        dry (an evicted row drops out by losing RUNNING state); with
        nothing evictable a row stalls an iteration instead. The
        speculative window shrinks before anyone is evicted: in-flight
        draft tokens cost accept rate when dropped, never correctness.
        Returns the rows and each row's window."""
        ready: List[_Seq] = []
        caps: Dict[int, int] = {}
        for seq in [s for s in self.active if s.state == RUNNING]:
            if seq.state != RUNNING:
                continue
            t_cap = window(seq)
            ok = (self._alloc_for(seq, seq.n_cached + t_cap)
                  and self._cow_span(seq, seq.n_cached, t_cap))
            while not ok and t_cap > 1:
                t_cap -= 1
                record_counter("serve.spec_shrink")
                ok = (self._alloc_for(seq, seq.n_cached + t_cap)
                      and self._cow_span(seq, seq.n_cached, t_cap))
            while not ok and self._evict_one(protect=seq):
                t_cap = 1
                ok = (self._alloc_for(seq, seq.n_cached + 1)
                      and self._cow_span(seq, seq.n_cached, 1))
            if ok:
                ready.append(seq)
                caps[seq.req.request_id] = t_cap
            else:
                record_counter("serve.decode_stall")
        return [s for s in ready if s.state == RUNNING], caps

    def _emit(self, seq: _Seq, tok: int, now: float):
        """Append one verified token to ``seq`` with its bookkeeping."""
        seq.n_cached += 1
        seq.tokens.append(int(tok))
        self._jtoks.append((seq.req.request_id, seq.tokens[-1]))
        if seq.first_token_t is None:
            seq.first_token_t = now
            self.slo["ttft"].record(now - seq.arrival)
        elif seq.token_times:
            self.slo["tpot"].record(now - seq.token_times[-1])
        seq.token_times.append(now)

    def _redrive(self, rows: List[_Seq], e: PoisonError) -> List[_Seq]:
        """Quarantine the row a PoisonError names and return the others
        for a re-drive of the batch; re-raise when it names no row of
        this batch."""
        if not self._pools_alive():
            raise e
        bad = next((s for s in rows if s.req.request_id == e.rid), None)
        if bad is None:
            raise e  # not attributable to this batch
        self._quarantine(bad, e.cause)
        self._redrives += 1
        record_counter("serve.decode_redrive")
        return [s for s in rows if s is not bad]

    def _decode_batch(self) -> List[_Seq]:
        if self.speculative:
            return self._decode_spec_batch()
        rows, _ = self._grow_rows(lambda s: 1)
        if not rows:
            return []
        faults.inject("serve.decode.before",
                      rids=[s.req.request_id for s in rows])
        max_nb = self.serve.max_nb
        # re-drive loop: a PoisonError attributable to one row drops that
        # row (quarantined) and re-runs the batch without it; rows are
        # independent (disjoint blocks, per-row tables), so survivors'
        # tokens equal a batch that never held the poison
        while rows:
            rids = [s.req.request_id for s in rows]
            n = len(rows)
            bucket = next(b for b in self.serve.decode_buckets if b >= n)
            # ids | positions | tables in one buffer: one copy per step;
            # padding rows keep token 0, position 0 and the null table
            host = np.zeros((bucket * (2 + max_nb),), np.int32)
            tables = host[2 * bucket:].reshape(bucket, max_nb)
            for i, seq in enumerate(rows):
                host[i] = seq.tokens[-1]
                host[bucket + i] = seq.n_cached
                tables[i] = pad_table(seq.blocks, max_nb)
            t0 = time.perf_counter()
            try:
                faults.inject("serve.decode.poison", rids=rids)
                with comm_span("serve.decode", nbytes=bucket * 4,
                               site="serve.decode"):
                    dev = self._to_device(host)
                    logits = self._base_step(
                        llama_paged_decode_step, self.params, self.k_pool,
                        self.v_pool, dev[2 * bucket:].view(bucket, max_nb),
                        dev[bucket:2 * bucket], dev[:bucket], self.config)
                    faults.inject("serve.decode.logits", rids=rids,
                                  logits=logits)
                    next_tok, finite = torch.stack(
                        [logits[:n].argmax(-1),
                         torch.isfinite(logits[:n]).all(-1).long()]
                    ).tolist()
            except PoisonError as e:
                rows = self._redrive(rows, e)
                continue
            break
        if not rows:
            return []
        t1 = time.perf_counter()
        self._decode_s += t1 - t0
        self.decode_steps += 1
        self._mark_compiled("decode", bucket, t1 - t0)
        live = list(enumerate(rows))
        if self._nan_check and not all(finite):
            # per-row screen: quarantine rows whose logits went
            # non-finite; the survivors' argmax stands (rows are
            # independent)
            for i, seq in [p for p in live if not finite[p[0]]]:
                self._quarantine(seq, "non-finite decode logits")
            live = [p for p in live if finite[p[0]]]
        if self.tracer is not None:
            self.tracer.decode([s.req.request_id for _, s in live],
                               t0, t1, self.iteration)
        self._last_tokens += len(live)
        done = []
        now = self._now()
        for i, seq in live:
            self._emit(seq, next_tok[i], now)
            if seq.done():
                self._finish_seq(seq, t1)
                done.append(seq)
        faults.inject("serve.decode.after",
                      rids=[s.req.request_id for _, s in live])
        return done

    def _decode_spec_batch(self) -> List[_Seq]:
        """Speculative decode iteration: up to K host-chained DRAFT steps
        propose lookahead tokens per RUNNING row, then ONE batched
        base-model verify step scores all K+1 positions through the
        multi-token paged read and commits only the accepted prefix's KV.
        Every emitted token is the BASE model's greedy argmax at its
        position, so the stream equals sequential decode and the journal
        only ever sees verified tokens."""
        K = self.draft_k
        max_nb = self.serve.max_nb
        # per-row lookahead cap: never past max_new or the table width;
        # floor 1, so a degenerate row still advances one token
        rows, caps = self._grow_rows(lambda s: max(1, min(
            K + 1, s.req.max_new_tokens - len(s.generated),
            self.serve.max_seq_len - s.n_cached)))
        if not rows:
            return []
        faults.inject("serve.decode.before",
                      rids=[s.req.request_id for s in rows])
        # -- draft phase: batched single-token steps, host-chained (each
        # argmax feeds the next step). Rows past their window are padding
        # rows (null table, position 0). The first proposing step of a
        # row feeds tokens[-1], as the verify feeds fed[:, 0].
        t0d = time.perf_counter()
        proposals: Dict[int, List[int]] = {}
        last_out: Dict[int, int] = {}
        drafted = False
        bucket = next(b for b in self.serve.decode_buckets if b >= len(rows))
        for _ in range(K):
            host = np.zeros((bucket * (2 + max_nb),), np.int32)
            tables = host[2 * bucket:].reshape(bucket, max_nb)
            stepping = []
            for i, seq in enumerate(rows):
                rid = seq.req.request_id
                if seq.draft_pos >= seq.n_cached + caps[rid] - 1:
                    continue
                p = seq.draft_pos
                host[i] = (seq.tokens[p] if p < len(seq.tokens)
                           else last_out[rid])
                host[bucket + i] = p
                tables[i] = pad_table(seq.blocks, max_nb)
                stepping.append((i, seq))
            if not stepping:
                break
            td0 = time.perf_counter()
            dev = self._to_device(host)
            dl, self.k_draft, self.v_draft = llama_paged_decode_step(
                self.draft_params, self.k_draft, self.v_draft,
                dev[2 * bucket:].view(bucket, max_nb),
                dev[bucket:2 * bucket], dev[:bucket], self.draft_config,
                tp=self.tp)
            nxt = dl.argmax(-1).tolist()
            td1 = time.perf_counter()
            self._draft_s += td1 - td0
            self.draft_steps += 1
            self._mark_compiled("draft", bucket, td1 - td0)
            drafted = True
            for i, seq in stepping:
                rid = seq.req.request_id
                seq.draft_pos += 1
                last_out[rid] = nxt[i]
                if seq.draft_pos > seq.n_cached:
                    proposals.setdefault(rid, []).append(nxt[i])
        if drafted and self.tracer is not None:
            self.tracer.phase("draft", t0d, time.perf_counter(),
                              self.iteration)
        # -- verify phase: one batched K+1-position base step; fed |
        # qstart | t_live | tables in one buffer, one copy each way. The
        # re-drive loop mirrors sequential decode's.
        T = K + 1
        while rows:
            rids = [s.req.request_id for s in rows]
            n = len(rows)
            bucket = next(b for b in self.serve.decode_buckets if b >= n)
            host = np.zeros((bucket * (T + 2 + max_nb),), np.int32)
            fed = host[:bucket * T].reshape(bucket, T)
            qstart = host[bucket * T:bucket * (T + 1)]
            t_live = host[bucket * (T + 1):bucket * (T + 2)]
            tables = host[bucket * (T + 2):].reshape(bucket, max_nb)
            for i, seq in enumerate(rows):
                rid = seq.req.request_id
                props = proposals.get(rid, [])[:caps[rid] - 1]
                fed[i, 0] = seq.tokens[-1]
                fed[i, 1:1 + len(props)] = props
                qstart[i] = seq.n_cached
                t_live[i] = 1 + len(props)
                tables[i] = pad_table(seq.blocks, max_nb)
            t0 = time.perf_counter()
            try:
                faults.inject("serve.decode.poison", rids=rids)
                with comm_span("serve.verify", nbytes=bucket * T * 4,
                               site="serve.verify"):
                    dev = self._to_device(host)
                    o = bucket * T
                    out, clen, fin = self._base_step(
                        llama_paged_verify_step, self.params, self.k_pool,
                        self.v_pool,
                        dev[o + 2 * bucket:].view(bucket, max_nb),
                        dev[o:o + bucket], dev[o + bucket:o + 2 * bucket],
                        dev[:o].view(bucket, T), self.config)
                    faults.inject("serve.decode.logits", rids=rids,
                                  logits=out)
                    got = torch.cat([out.flatten(), clen,
                                     fin.int()]).tolist()
            except PoisonError as e:
                rows = self._redrive(rows, e)
                continue
            break
        if not rows:
            return []
        t1 = time.perf_counter()
        self._decode_s += t1 - t0
        self.decode_steps += 1
        self._mark_compiled("verify", bucket, t1 - t0)
        out = [got[i * T:(i + 1) * T] for i in range(bucket)]
        clen = got[o:o + bucket]
        fin = got[o + bucket:o + 2 * bucket]
        live = list(enumerate(rows))
        if self._nan_check and not all(fin[:len(rows)]):
            # the verify step returns tokens, not logits: its finite
            # screen runs on the device and comes back per row
            for i, seq in [p for p in live if not fin[p[0]]]:
                self._quarantine(seq, "non-finite decode logits")
            live = [p for p in live if fin[p[0]]]
        if self.tracer is not None:
            self.tracer.decode([s.req.request_id for _, s in live],
                               t0, t1, self.iteration)
            self.tracer.phase("verify", t0, t1, self.iteration)
        done: List[_Seq] = []
        now = self._now()
        for i, seq in live:
            self._spec_proposed += int(t_live[i]) - 1
            # accepted draft credit = commit_len - 1: the +1 is the
            # base's own correction/next token
            self._spec_accepted += max(0, clen[i] - 1)
            emitted = 0
            for j in range(clen[i]):
                self._emit(seq, out[i][j], now)
                emitted += 1
                if seq.done():
                    # eos/max_new inside the window: later verified tokens
                    # come after the stop, and sequential decode never
                    # makes them
                    break
            self._last_tokens += emitted
            # roll the draft back to the last verified position: its
            # cache past the accepted prefix reflects rejected tokens
            seq.draft_pos = min(seq.draft_pos, seq.n_cached)
            if seq.done():
                self._finish_seq(seq, t1)
                done.append(seq)
        faults.inject("serve.decode.after",
                      rids=[s.req.request_id for _, s in live])
        return done

    # -- preemption and live weight push ------------------------------------

    def request_preemption(self) -> None:
        """Signal a graceful stop: run() exits at the next iteration
        boundary with queued/active requests intact (thread/signal
        safe)."""
        self._preempt.set()

    def clear_preemption(self) -> None:
        """Re-arm a preempted engine: run() continues from intact queue/
        active state (a deterministic replay resumes identically)."""
        self._preempt.clear()

    def install_preemption_handler(self, signum: int = signal.SIGTERM
                                   ) -> None:
        """SIGTERM -> request_preemption(); the loop itself never runs
        device code from the handler."""
        try:
            self._prev_handler = signal.signal(
                signum, lambda s, f: self._preempt.set())
            self._signum = signum
        except ValueError:
            warnings.warn(
                "cannot install a signal handler off the main thread; "
                "use request_preemption()", RuntimeWarning)

    def uninstall_preemption_handler(self) -> None:
        if self._signum is not None:
            signal.signal(self._signum, self._prev_handler or signal.SIG_DFL)
            self._signum = None
            self._prev_handler = None

    def swap_weights(self, source, at_iteration: Optional[int] = None
                     ) -> Dict[str, Any]:
        """Live weight push: replace the model weights without restarting
        the engine or dropping a request.

        ``source`` is a checkpoint directory (a ``save_state_dict`` dir or
        a CheckpointManager root, whose newest complete checkpoint is
        used; a training checkpoint's ``"params"`` subtree is taken when
        the engine's tree has no ``"params"`` key) or an in-memory
        parameter tree (torch tensors or numpy arrays). The new tree must
        match the current one's structure and shapes exactly. Each leaf is
        copied INTO the current leaf (``copy_``, cast to its dtype), one
        leaf at a time and a directory's leaf files read one at a time,
        so peak extra memory is one weight and the draft model's leaves,
        views of the base's, stay in step; the KV pools, block tables and
        scheduler state are untouched.

        With ``at_iteration`` the swap is deferred to that iteration's
        boundary, the safe drain point (the previous step has synced its
        tokens, nothing is in flight); without it the swap applies now.
        With identical weights the post-swap stream is bit-identical;
        in-flight sequences keep their KV prefix either way.

        At mp > 1 the source is the FULL tree, as at mp 1: each leaf's
        full shape is checked, then the leaf is sliced to this rank's
        shard before the copy."""
        if at_iteration is not None and at_iteration > self.iteration:
            self._pending_swap = (source, int(at_iteration))
            self._event("swap_scheduled", int(at_iteration))
            return {"scheduled_at": int(at_iteration)}
        return self._apply_swap(source)

    def _resolve_swap_source(self, source):
        if not isinstance(source, (str, bytes, os.PathLike)):
            return source, None
        path = os.path.abspath(os.fsdecode(source))
        try:
            entries = os.listdir(path)
        except OSError:
            entries = []
        if any(_STEP_RE.match(n) for n in entries):
            # a manager root: serve from its newest complete checkpoint
            resolved = CheckpointManager(path).latest_path()
            if resolved is None:
                raise FileNotFoundError(
                    f"swap_weights: no complete checkpoint under {path!r}")
            path = resolved
        sl._wait_pending(path)  # an in-flight async save to this very dir
        restored = sl.read_tree(path)
        # a training checkpoint nests the weights under "params"
        if isinstance(restored, dict) and "params" in restored \
                and "params" not in self.params:
            restored = restored["params"]
        return restored, path

    def _apply_swap(self, source) -> Dict[str, Any]:
        faults.inject("serve.swap.before", iteration=self.iteration)
        t0 = time.perf_counter()
        new_tree, path = self._resolve_swap_source(source)
        n_leaves = [0]

        def swap_fill(target, saved, leaf_path, spec=None):
            if isinstance(target, dict):
                if not isinstance(saved, dict) or set(target) != set(saved):
                    raise ValueError(
                        f"swap_weights: param tree mismatch at "
                        f"{leaf_path or '<root>'!r}: engine has "
                        f"{sorted(target)}, source has "
                        f"{sorted(saved) if isinstance(saved, dict) else type(saved)}")
                for k in target:
                    swap_fill(target[k], saved[k],
                              f"{leaf_path}.{k}" if leaf_path else str(k),
                              None if spec is None else spec[k])
                return
            if isinstance(target, (list, tuple)):
                if not isinstance(saved, (list, tuple)) \
                        or len(target) != len(saved):
                    raise ValueError(
                        f"swap_weights: param tree mismatch at "
                        f"{leaf_path!r}")
                for i, (t, s) in enumerate(zip(target, saved)):
                    swap_fill(t, s, f"{leaf_path}[{i}]")
                return
            shape = tuple(saved.shape)
            splits = ([] if spec is None else split_dims(
                spec, {"mp": self.mp}, {"mp": self.tp.rank}))
            full = list(target.shape)
            region = [slice(0, n) for n in shape]
            for d, parts, index in splits:
                full[d] *= parts
                n = shape[d] // parts
                region[d] = slice(index * n, (index + 1) * n)
            if tuple(full) != shape:
                raise ValueError(
                    f"swap_weights: shape mismatch at {leaf_path!r}: "
                    f"engine {tuple(full)}, source {shape}")
            if isinstance(saved, sl.LeafFile):
                # only this rank's slice is read from the file
                saved = saved.read(tuple(region))
            else:
                if not isinstance(saved, torch.Tensor):
                    saved = _tensor_from_numpy(saved)
                if splits:
                    saved = saved[tuple(region)]
            if saved is not target:
                target.copy_(saved)
            n_leaves[0] += 1

        drained_running = sum(1 for s in self.active if s.state == RUNNING)
        drained_prefill = sum(1 for s in self.active if s.state == PREFILL)
        swap_fill(self.params, new_tree, "", self._tp_specs)
        self.swaps += 1
        record_counter("serve.swap")
        stats = {
            "iteration": self.iteration,
            "swap_ms": (time.perf_counter() - t0) * 1e3,
            "n_leaves": n_leaves[0],
            "in_flight_running": drained_running,
            "in_flight_prefill": drained_prefill,
            "source": path,
        }
        self.last_swap = stats
        self._event("swap", n_leaves[0])
        if self.recorder is not None:
            self.recorder.record({"iteration": self.iteration,
                                  "event": "swap", **{
                                      k: v for k, v in stats.items()
                                      if k != "iteration"}})
        if self._journal is not None:
            self._journal.swap(self.iteration, path)
        faults.inject("serve.swap.after", iteration=self.iteration)
        return stats

    # -- driving loops ------------------------------------------------------

    def _now(self) -> float:
        return self._clock

    def run(self, requests: Sequence[Request], deterministic: bool = False,
            max_iterations: int = 100000) -> Dict[str, Any]:
        """Drive the engine until every request finishes.

        Wall mode (default): ``arrival`` is seconds from start; the engine
        clock is wall time and idle gaps are slept through. Deterministic
        mode: ``arrival`` is an ITERATION index and the clock counts
        iterations, so a replay reproduces the event log and tokens."""
        pending = sorted(requests, key=lambda r: r.arrival)
        t0 = time.perf_counter()
        try:
            while pending or not self.idle():
                stop = self._preempt.is_set() or faults.fires("serve.preempt")
                clock = (float(self.iteration) if deterministic
                         else time.perf_counter() - t0)
                if self.tp is not None:
                    # every rank takes rank 0's clock and stops together
                    stop, clock = self._agree(stop, clock)
                if stop:
                    # graceful preemption: stop at the iteration boundary
                    # (nothing in flight), dump the post-mortem ring and
                    # return with queued/active work intact
                    self._was_preempted = True
                    record_counter("serve.preempted")
                    self._event("preempt_stop")
                    if self.recorder is not None:
                        self.recorder.dump("preemption")
                    break
                if self.iteration >= max_iterations:
                    raise RuntimeError("engine exceeded max_iterations")
                self._clock = clock
                while pending and pending[0].arrival <= self._clock:
                    self.submit(pending.pop(0))
                if self.idle() and pending:
                    if deterministic:
                        self.iteration += 1
                    else:
                        time.sleep(min(pending[0].arrival - self._clock,
                                       0.01))
                    continue
                self.step()
                if not deterministic and self.tp is None:
                    self._clock = time.perf_counter() - t0
        except BaseException:
            # a crashed run leaves a LEAK-FREE pool: every live sequence
            # goes back to the front of the waiting queue (order kept)
            # with its blocks released, so a successor engine, or
            # recover(), inherits clean state
            while self.active:
                seq = self.active.pop()
                self._release(seq)
                seq.state = WAITING
                seq.n_cached = 0
                seq.draft_pos = 0
                self.waiting.insert(0, seq)
            if self.recorder is not None:
                self.recorder.dump("exception")
            raise
        if self._journal is not None:
            # clean exit: drain the buffered tokens/finish marks so the
            # journal of an idle engine is complete on disk
            self._journal.flush()
        return self.stats()

    def drain(self, deterministic: bool = False,
              max_iterations: int = 100000
              ) -> Dict[int, Tuple[str, Optional[str]]]:
        """Graceful wind-down: stop admitting (every later ``submit()``
        rejects with cause ``draining``), run the accepted work to
        completion and return the total :meth:`outcomes` map. The engine
        stays usable: :meth:`undrain` re-opens admissions."""
        self._draining = True
        record_counter("serve.drain")
        self._event("drain")
        self.run([], deterministic=deterministic,
                 max_iterations=max_iterations)
        return self.outcomes()

    def undrain(self) -> None:
        """Re-open admissions after :meth:`drain`."""
        self._draining = False
        self._event("undrain")

    def recover(self, journal_path: Optional[str] = None) -> Dict[str, Any]:
        """Rebuild scheduler state from an engine journal after a crash.

        The journal holds every accepted request and every token the dead
        engine emitted. Greedy decoding is deterministic in (prompt +
        generated history), so re-queueing each unfinished request with
        its journaled tokens and re-driving it through the ordinary
        preempted-sequence path (re-prefill the cached context, resume
        decoding) reproduces the remaining stream; tokens emitted after
        the journal's last flush are re-derived. Call on a FRESH engine,
        or on one whose ``run()`` raised (its demoted sequences are
        discarded for the journal's record); then ``run([])`` drives the
        recovered requests to completion. The journal is reopened for
        append."""
        path = journal_path or self.journal_path
        if not path:
            raise ValueError(
                "recover() needs a journal: pass journal_path= or build the "
                "engine with journal=/PADDLE_TPU_TORCH_SERVE_JOURNAL")
        if self.tp is not None:
            # every rank reads the same bytes: after rank 0's engine
            # opened the journal, before its recovery appends to it
            dist.barrier(group=self.tp.pg)
        st = read_journal(path)
        if self.tp is not None:
            dist.barrier(group=self.tp.pg)
        # up-front screen: either this engine can re-drive the journal
        # identically, or refuse before any state is touched. kv_dtype is
        # the one stream-changing axis; prefix_cache and speculative
        # differences recover freely
        j_dtype = st.meta.get("kv_dtype")
        if j_dtype is not None and j_dtype != self.kv_dtype:
            raise JournalCompatError(
                f"recover(): journal {path!r} was written with "
                f"kv_dtype={j_dtype!r} but this engine stores "
                f"{self.kv_dtype!r}; crossing the int8 quantization "
                f"boundary changes token streams, so the re-drive would "
                f"not be bit-identical")
        for rid in st.unfinished_rids():
            rec = st.requests[rid]
            worst = len(rec["prompt"]) + int(rec["max_new_tokens"])
            if worst > self.serve.max_seq_len:
                raise JournalCompatError(
                    f"recover(): journaled request {rid} needs {worst} "
                    f"tokens but this engine's max_seq_len is "
                    f"{self.serve.max_seq_len}")
            if self.pool.blocks_for(worst) > self.serve.num_blocks - 1:
                raise JournalCompatError(
                    f"recover(): journaled request {rid} can never fit "
                    f"this engine's pool ({worst} tokens > "
                    f"{self.serve.num_blocks - 1} usable blocks)")
        for seq in itertools.chain(self.active, self.waiting):
            self._release(seq)
        self.active, self.waiting = [], []
        if self.pool.used_blocks:
            raise RuntimeError(
                f"recover(): pool leaked {self.pool.used_blocks} blocks")
        terminal = st.terminal_rids()
        n_replayed = n_prefinished = 0
        for rid in st.unfinished_rids():
            rec = st.requests[rid]
            req = Request(
                prompt=rec["prompt"],
                max_new_tokens=rec["max_new_tokens"],
                request_id=rid, eos_id=rec.get("eos_id"),
                arrival=float(rec.get("arrival", 0.0)),
                priority=int(rec.get("priority", 0)),
                ttft_deadline=rec.get("ttft_deadline"),
                deadline=rec.get("deadline"))
            seq = _Seq(req, self._clock)
            seq.order = next(self._seqno)
            seq.tokens.extend(st.tokens.get(rid, ()))
            seq.recovered = True
            if seq.generated:
                # its first token predates this engine: keep the SLO
                # histograms honest by not re-measuring TTFT
                seq.first_token_t = seq.arrival
            if seq.done():
                # crashed after its last token but before its finish mark
                # was journaled: already complete, no re-drive
                seq.state = FINISHED
                self.finished.append(seq)
                n_prefinished += 1
            else:
                self.waiting.append(seq)
                n_replayed += 1
        self._recovered = n_replayed + n_prefinished
        known = list(st.requests) + list(st.rejected)
        if known:
            self._rid = itertools.count(max(known) + 1)
        if self._journal is None:
            if self._writes_journal:
                self._journal = EngineJournal(
                    path, fsync=envs.get(ENV_SERVE_JOURNAL_FSYNC),
                    resume=True, meta=self._journal_meta())
            self.journal_path = path
        else:
            # in-place recovery after run() raised: the writer may hold
            # token pairs from before the crash; they predate the read
            # above, and draining them now would duplicate streams
            self._journal.discard_pending()
        if self._journal is not None:
            self._journal.recovered(self._recovered, st.torn_lines)
            for seq in self.finished[len(self.finished) - n_prefinished:]:
                self._journal.finish(seq.req.request_id)
        record_counter("serve.recover")
        self._event("recover", self._recovered)
        return {
            "recovered": self._recovered,
            "replayed": n_replayed,
            "already_finished": n_prefinished,
            "terminal_in_journal": len(terminal),
            "torn_lines": st.torn_lines,
            "journal_swaps": st.swaps,
        }

    def stats(self) -> Dict[str, Any]:
        """Throughput/latency aggregates over finished requests (engine
        clock: seconds in wall mode, iterations in deterministic mode),
        with the JAX engine's keys in its order, then the port's own:
        ``device``, ``used_blocks`` and the host-clock mean of each decode
        step and prefill chunk (each ends in the device->host copy of its
        [B] results, so the device work is inside it; with speculation on
        a decode step is one verify step, and ``speculative`` also holds
        the draft steps' count and mean).

        Requests that never produced a first token are counted in
        ``unfinished``, so the TTFT percentiles are conditioned on
        completion. ``compiles`` holds the first call of each step shape
        (seconds). The ``*_stream_*`` entries are the log-bucketed
        histogram estimates next to the exact percentiles."""
        seqs = self.finished
        gen = sum(len(s.generated) for s in seqs)
        ttfts = [s.first_token_t - s.arrival for s in seqs
                 if s.first_token_t is not None]
        gaps: List[float] = []
        for s in seqs:
            gaps.extend(np.diff(s.token_times).tolist())
        span = (max((s.token_times[-1] for s in seqs if s.token_times),
                    default=0.0)
                - min((s.arrival for s in seqs), default=0.0))
        pct = (lambda a, q: float(np.percentile(a, q)) if a else None)
        unfinished = (len(self.waiting) + len(self.active)
                      + sum(1 for s in seqs if s.first_token_t is None))
        return {
            "requests": len(seqs),
            "unfinished": unfinished,
            "generated_tokens": gen,
            "elapsed_s": span,
            "tokens_per_sec": gen / span if span > 0 else None,
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "tpot_p50_s": pct(gaps, 50),
            "tpot_p99_s": pct(gaps, 99),
            "ttft_stream_p50_s": self.slo["ttft"].percentile(50),
            "ttft_stream_p99_s": self.slo["ttft"].percentile(99),
            "tpot_stream_p50_s": self.slo["tpot"].percentile(50),
            "tpot_stream_p99_s": self.slo["tpot"].percentile(99),
            "preemptions": self.preemptions,
            "preempted": self._was_preempted,
            "weight_swaps": self.swaps,
            "iterations": self.iteration,
            "compiles": {f"{k}_{v}": round(t, 3)
                         for (k, v), t in sorted(self._compiled.items())},
            "pool_blocks": self.serve.num_blocks - 1,
            "mp": self.mp,
            # the pools here are this rank's own
            "pool_bytes_per_rank": pool_bytes_per_rank(
                (self.k_pool, self.v_pool, self.k_scale, self.v_scale,
                 self.k_draft, self.v_draft)),
            "rejected": len(self.rejected),
            "shed": len(self.shed),
            "failed": len(self.failed),
            "decode_redrives": self._redrives,
            "recovered": self._recovered,
            "kv_dtype": self.kv_dtype,
            "prefix_cache": (dict(self.cache.stats(),
                                  cached_blocks=self.pool.cached_blocks,
                                  cow_copies=self._cow_copies)
                             if self.cache is not None else None),
            "speculative": ({
                "draft_k": self.draft_k,
                "draft_layers": self.draft_config.num_hidden_layers,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "accept_rate": (self._spec_accepted / self._spec_proposed
                                if self._spec_proposed else None),
                "draft_steps": self.draft_steps,
                "draft_step_ms_mean": (self._draft_s * 1e3
                                       / self.draft_steps
                                       if self.draft_steps else None),
            } if self.speculative else None),
            "outcomes": self.outcomes(),
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "decode_step_ms_mean": (self._decode_s * 1e3 / self.decode_steps
                                    if self.decode_steps else None),
            "prefill_chunk_ms_mean": (
                self._prefill_s * 1e3 / self.prefill_chunks
                if self.prefill_chunks else None),
            "used_blocks": self.pool.used_blocks,
            "device": str(self.device),
        }

    def outcomes(self) -> Dict[int, Tuple[str, Optional[str]]]:
        """Disposition of EVERY request this engine has seen:
        ``rid -> (state, cause)``. Each submitted request appears in
        exactly one state (terminal: finished/rejected/shed/failed with a
        cause; live requests report their current scheduler state)."""
        out: Dict[int, Tuple[str, Optional[str]]] = {}
        for req, cause in self.rejected:
            out[req.request_id] = ("rejected", cause)
        for seq in self.finished:
            out[seq.req.request_id] = (FINISHED, None)
        for seq in self.shed:
            out[seq.req.request_id] = (SHED, seq.fail_cause)
        for seq in self.failed:
            out[seq.req.request_id] = (FAILED, seq.fail_cause)
        for seq in itertools.chain(self.waiting, self.active):
            out[seq.req.request_id] = (seq.state, None)
        return out

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Live metric snapshot, any time mid-run: the streaming SLO
        histograms plus scheduler gauges, straight from the registry (key
        order is the registration order)."""
        return self.registry.snapshot()

    def render_prometheus(self) -> str:
        """Prometheus text exposition through the registry (``# HELP`` /
        ``# TYPE`` pairs ahead of each family)."""
        return self.registry.render_prometheus()
