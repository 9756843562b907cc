"""Continuous-batching serving engine (port of the core of
``paddle_tpu/inference/engine.py``).

Orca-style iteration-level scheduling (Yu et al., OSDI '22) over the vLLM
paged KV cache (Kwon et al., SOSP '23). Each ``step()``:
  1. admits waiting requests while the free-block budget covers their
     prompt (plus one decode block of headroom);
  2. runs one prefill chunk for the oldest admitted prompt, allocating its
     blocks lazily per chunk (shrinking the chunk's live span to the
     pool's headroom before it evicts anyone);
  3. runs one decode batch over all RUNNING sequences, padded to a batch
     bucket, allocating each sequence's next block as it crosses a block
     boundary and PREEMPTING-BY-EVICTION (lowest priority, then youngest,
     back to the front of the waiting queue, blocks freed, recompute on
     readmission) when the pool runs dry.

The scheduling decisions, the event log and the eviction key are the JAX
engine's, so a deterministic replay gives the same token streams and the
same events in the same order. Greedy decoding; the argmax and the
non-finite screen run on the device and only [B] values come back to the
host per step. A non-finite logit RAISES: the JAX engine's quarantine,
admission control, deadlines, journal, prefix cache, tensor-parallel
serving and telemetry are not ported yet.

int8 paged KV (``ServeConfig(kv_dtype="int8")``, the JAX PR 16 path):
the pools hold int8 codes with f32 scale pools, one scale per block,
kv-head and column, written once per column by ``kv_quant_columns`` on
the prefill scatter, the decode update and the verify commit alike. The
draft pools of speculative decoding keep the model dtype.

Speculative decoding (``ServeConfig(speculative=True)``, the JAX PR 18
path): a draft model (default: the base truncated to its first layer,
:func:`~paddle_tpu_torch.models.llama.make_draft_model`) proposes up to
``draft_k`` tokens per row through host-chained decode steps on its own
pools, which share the base block tables; then ONE batched verify step
scores all K+1 positions and commits only the accepted prefix's KV.
Every emitted token is the base model's greedy argmax, so streams equal
sequential decode for any draft. With no prefix cache here, the JAX
engine's copy-on-write span check is trivially true.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.llama import (LlamaConfig, init_paged_kv_pool,
                            init_paged_kv_scales, llama_paged_decode_step,
                            llama_paged_prefill_chunk,
                            llama_paged_verify_step, make_draft_model)
from .kv_cache import BlockPool, pad_table

WAITING, PREFILL, RUNNING, FINISHED = "waiting", "prefill", "running", \
    "finished"


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is seconds from engine start
    (wall mode) or the iteration index (deterministic replay mode).
    Higher ``priority`` survives eviction longer."""
    prompt: Sequence[int]
    max_new_tokens: int = 16
    request_id: Optional[int] = None
    eos_id: Optional[int] = None
    arrival: float = 0.0
    priority: int = 0


@dataclasses.dataclass
class ServeConfig:
    block_size: int = 128
    num_blocks: int = 64          # includes the reserved null block 0
    max_batch: int = 8
    prefill_chunk: int = 64
    max_seq_len: int = 1024       # bounds the block-table width
    decode_buckets: Optional[Tuple[int, ...]] = None
    # speculative decoding: draft + batched verification (the JAX knob
    # defaults: off, 4 proposals per row per iteration)
    speculative: bool = False
    draft_k: int = 4
    # KV storage: "auto" (the model dtype) or "int8" (codes + f32 scales)
    kv_dtype: str = "auto"

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
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if self.kv_dtype not in ("auto", "int8"):
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


class InferenceEngine:
    """Continuous-batching engine over a paged KV cache.

    >>> eng = InferenceEngine(params, config, ServeConfig())
    >>> stats = eng.run([Request(prompt, max_new_tokens=32), ...])

    ``device`` defaults to the card; ``params`` must already live there.
    With speculation on, ``draft_params``/``draft_config`` name the draft
    model (default: :func:`make_draft_model`). Drive it from a single
    thread."""

    def __init__(self, params: Dict[str, Any], config: LlamaConfig,
                 serve: Optional[ServeConfig] = None,
                 record_events: bool = False, device=None,
                 draft_params: Optional[Dict[str, Any]] = None,
                 draft_config: Optional[LlamaConfig] = None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.config = config
        self.serve = serve or ServeConfig()
        self.pool = BlockPool(self.serve.num_blocks, self.serve.block_size)
        self.k_pool, self.v_pool = init_paged_kv_pool(
            config, self.serve.num_blocks, self.serve.block_size,
            kv_dtype=self.serve.kv_dtype, device=self.device)
        # int8 KV: the scale pools, passed through every base-model step
        self.k_scale = self.v_scale = None
        if self.serve.kv_dtype == "int8":
            self.k_scale, self.v_scale = init_paged_kv_scales(
                config, self.serve.num_blocks, self.serve.block_size,
                device=self.device)
        self.draft_params = self.draft_config = None
        self.k_draft = self.v_draft = None
        self._spec_proposed = 0
        self._spec_accepted = 0
        self.draft_steps = 0
        self._draft_s = 0.0
        if self.serve.speculative:
            if draft_params is None:
                draft_params, draft_config = make_draft_model(params, config)
            elif draft_config is None:
                raise ValueError("draft_params given without draft_config")
            self.draft_params, self.draft_config = draft_params, draft_config
            # the draft pools mirror the base pool's block geometry (one
            # shared block table per sequence) in the model dtype, int8 KV
            # or not: draft KV shapes proposals only, never output bytes
            self.k_draft, self.v_draft = init_paged_kv_pool(
                draft_config, self.serve.num_blocks, self.serve.block_size,
                device=self.device)
        self.record_events = record_events
        self.events: List[Tuple] = []
        self.waiting: List[_Seq] = []
        self.active: List[_Seq] = []      # PREFILL + RUNNING, FCFS order
        self.finished: List[_Seq] = []
        self.iteration = 0
        self.preemptions = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self._decode_s = 0.0
        self._prefill_s = 0.0
        self._rid = itertools.count()
        self._seqno = itertools.count()
        self._clock = 0.0

    # -- bookkeeping --------------------------------------------------------

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
        return True

    def _release(self, seq: _Seq):
        if seq.blocks:
            self.pool.free(seq.blocks)
            seq.blocks = []

    def _evict_one(self, protect: Optional[_Seq] = None) -> bool:
        """Preempt the lowest-priority, then YOUNGEST running sequence:
        free its blocks and push it to the FRONT of the waiting queue for
        recompute-style readmission (its generated tokens are kept)."""
        victims = [s for s in self.active
                   if s.state == RUNNING and s is not protect]
        if not victims:
            return False
        victim = max(victims, key=lambda s: (-s.req.priority, s.arrival,
                                             s.order))
        self.active.remove(victim)
        self._release(victim)
        victim.state = WAITING
        victim.n_cached = 0
        victim.draft_pos = 0
        self.waiting.insert(0, victim)
        self.preemptions += 1
        self._event("evict", victim.req.request_id)
        return True

    def _finish_seq(self, seq: _Seq):
        seq.state = FINISHED
        if seq in self.active:
            self.active.remove(seq)
        self._release(seq)
        self.finished.append(seq)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue ``req``; returns its request id. Malformed requests (that
        can never be served at any load) raise ValueError."""
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
        seq = _Seq(req, self._clock)
        seq.order = next(self._seqno)
        self.waiting.append(seq)
        self._event("submit", req.request_id)
        return req.request_id

    def step(self) -> List[_Seq]:
        """One scheduler iteration: admit, one prefill chunk, one decode
        batch. Returns sequences that finished this iteration."""
        self.iteration += 1
        self._admit()
        done: List[_Seq] = []
        self._prefill_chunk(done)
        done += self._decode_batch()
        for seq in done:
            self._event("finish", seq.req.request_id, len(seq.generated))
        return done

    def idle(self) -> bool:
        return not self.waiting and not self.active

    def _base_step(self, fn, *args):
        """One base-model step ``fn`` over the engine's pools (and, with int8
        KV, its scale pools); stores the returned pools and returns what
        comes before them."""
        if self.k_scale is None:
            *res, self.k_pool, self.v_pool = fn(*args)
        else:
            *res, self.k_pool, self.v_pool, self.k_scale, self.v_scale = fn(
                *args, kv_scales=(self.k_scale, self.v_scale))
        return res[0] if len(res) == 1 else res

    # -- scheduler phases ---------------------------------------------------

    def _admit(self):
        while self.waiting and len(self.active) < self.serve.max_batch:
            seq = self.waiting[0]
            need = self.pool.blocks_for(seq.prefill_target) + 1
            if not self.pool.can_alloc(need):
                break
            self.waiting.pop(0)
            seq.state = PREFILL
            seq.n_cached = 0
            self.active.append(seq)
            self._event("admit", seq.req.request_id)

    def _prefill_chunk(self, done_out: List[_Seq]) -> bool:
        seq = next((s for s in self.active if s.state == PREFILL), None)
        if seq is None:
            return False
        rid = seq.req.request_id
        c = self.serve.prefill_chunk
        n_live = min(c, seq.prefill_target - seq.n_cached)
        # under pool pressure, shrink this chunk's live span to the
        # headroom the pool still has before resorting to eviction
        headroom = ((len(seq.blocks) + self.pool.available_blocks)
                    * self.pool.block_size - seq.n_cached)
        if 1 <= headroom < n_live:
            n_live = headroom
            self._event("prefill_shrink", rid, n_live)
        if not self._alloc_for(seq, seq.n_cached + n_live):
            # pool dry mid-prompt: steal from the youngest decoder; if
            # there is none, stall — decode progress will free blocks
            if not (self._evict_one(protect=seq)
                    and self._alloc_for(seq, seq.n_cached + n_live)):
                return False
        host = np.zeros((c + self.serve.max_nb,), np.int32)
        host[:n_live] = seq.tokens[seq.n_cached:seq.n_cached + n_live]
        host[c:] = pad_table(seq.blocks, self.serve.max_nb)
        t0 = time.perf_counter()
        dev = self._to_device(host)
        logits = self._base_step(
            llama_paged_prefill_chunk, self.params, self.k_pool, self.v_pool,
            dev[c:], seq.n_cached, dev[:c], n_live, self.config)
        tok, finite = torch.stack(
            [logits.argmax(-1), torch.isfinite(logits).all().long()]
        ).tolist()
        self._prefill_s += time.perf_counter() - t0
        self.prefill_chunks += 1
        if not finite:
            raise RuntimeError(f"request {rid}: non-finite prefill logits")
        seq.n_cached += n_live
        if seq.n_cached == seq.prefill_target:
            if not seq.generated:
                # fresh prompt: the final chunk's logits sample the first
                # new token (greedy)
                seq.tokens.append(int(tok))
                seq.first_token_t = self._now()
                seq.token_times.append(seq.first_token_t)
            if seq.done():
                self._finish_seq(seq)
                done_out.append(seq)
            else:
                seq.state = RUNNING
                if self.serve.speculative:
                    # bring the draft's cache up to n_cached before the
                    # first decode iteration touches this row
                    self._draft_prefill(seq)
        return True

    def _draft_prefill(self, seq: _Seq):
        """Chunked prefill of ``seq``'s cached tokens through the DRAFT
        model into the draft pools (shared block table). Draft state is
        derived only: an evicted row re-prefills it on readmission."""
        c = self.serve.prefill_chunk
        table = self._to_device(pad_table(seq.blocks, self.serve.max_nb))
        start, target = 0, seq.n_cached
        while start < target:
            n_live = min(c, target - start)
            ids = np.zeros((c,), np.int32)
            ids[:n_live] = seq.tokens[start:start + n_live]
            _, self.k_draft, self.v_draft = llama_paged_prefill_chunk(
                self.draft_params, self.k_draft, self.v_draft, table, start,
                self._to_device(ids), n_live, self.draft_config)
            start += n_live
        seq.draft_pos = target

    def _decode_batch(self) -> List[_Seq]:
        if self.serve.speculative:
            return self._decode_spec_batch()
        # grow each row across its block boundary, evicting when the pool
        # runs dry (an evicted row drops out of the batch by losing
        # RUNNING state); with nothing evictable the row stalls an
        # iteration instead — finishing rows free its blocks
        ready: List[_Seq] = []
        for seq in [s for s in self.active if s.state == RUNNING]:
            if seq.state != RUNNING:
                continue
            ok = self._alloc_for(seq, seq.n_cached + 1)
            while not ok and self._evict_one(protect=seq):
                ok = self._alloc_for(seq, seq.n_cached + 1)
            if ok:
                ready.append(seq)
        rows = [s for s in ready if s.state == RUNNING]
        if not rows:
            return []
        n = len(rows)
        bucket = next(b for b in self.serve.decode_buckets if b >= n)
        max_nb = self.serve.max_nb
        # ids | positions | tables in one buffer: one copy per step;
        # padding rows keep token 0, position 0 and the null table
        host = np.zeros((bucket * (2 + max_nb),), np.int32)
        tables = host[2 * bucket:].reshape(bucket, max_nb)
        for i, seq in enumerate(rows):
            host[i] = seq.tokens[-1]
            host[bucket + i] = seq.n_cached
            tables[i] = pad_table(seq.blocks, max_nb)
        t0 = time.perf_counter()
        dev = self._to_device(host)
        logits = self._base_step(
            llama_paged_decode_step, self.params, self.k_pool, self.v_pool,
            dev[2 * bucket:].view(bucket, max_nb), dev[bucket:2 * bucket],
            dev[:bucket], self.config)
        next_tok, finite = torch.stack(
            [logits[:n].argmax(-1), torch.isfinite(logits[:n]).all(-1).long()]
        ).tolist()
        self._decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        if not all(finite):
            bad = [s.req.request_id for s, f in zip(rows, finite) if not f]
            raise RuntimeError(f"requests {bad}: non-finite decode logits")
        done = []
        now = self._now()
        for i, seq in enumerate(rows):
            seq.n_cached += 1
            seq.tokens.append(int(next_tok[i]))
            if seq.first_token_t is None:
                seq.first_token_t = now
            seq.token_times.append(now)
            if seq.done():
                self._finish_seq(seq)
                done.append(seq)
        return done

    def _decode_spec_batch(self) -> List[_Seq]:
        """Speculative decode iteration: up to K host-chained DRAFT steps
        propose lookahead tokens per RUNNING row, then ONE batched
        base-model verify step scores all K+1 positions through the
        multi-token paged read and commits only the accepted prefix's KV.
        Every emitted token is the BASE model's greedy argmax at its
        position, so the stream equals sequential decode."""
        K = self.serve.draft_k
        max_nb = self.serve.max_nb
        # per-row lookahead cap: never past max_new or the table width;
        # floor 1, so a degenerate row still advances one token
        ready: List[_Seq] = []
        caps: Dict[int, int] = {}
        for seq in [s for s in self.active if s.state == RUNNING]:
            if seq.state != RUNNING:
                continue
            remaining = seq.req.max_new_tokens - len(seq.generated)
            t_cap = max(1, min(K + 1, remaining,
                               self.serve.max_seq_len - seq.n_cached))
            ok = self._alloc_for(seq, seq.n_cached + t_cap)
            # shrink the lookahead before evicting anyone: draft tokens
            # cost accept rate when dropped, never correctness
            while not ok and t_cap > 1:
                t_cap -= 1
                ok = self._alloc_for(seq, seq.n_cached + t_cap)
            while not ok and self._evict_one(protect=seq):
                t_cap = 1
                ok = self._alloc_for(seq, seq.n_cached + 1)
            if ok:
                ready.append(seq)
                caps[seq.req.request_id] = t_cap
        rows = [s for s in ready if s.state == RUNNING]
        if not rows:
            return []
        n = len(rows)
        bucket = next(b for b in self.serve.decode_buckets if b >= n)
        # -- draft phase: batched single-token steps, host-chained (each
        # argmax feeds the next step). Rows past their window are padding
        # rows (null table, position 0). The first proposing step of a
        # row feeds tokens[-1], as the verify feeds fed[:, 0].
        proposals: Dict[int, List[int]] = {}
        last_out: Dict[int, int] = {}
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
            t0 = time.perf_counter()
            dev = self._to_device(host)
            dl, self.k_draft, self.v_draft = llama_paged_decode_step(
                self.draft_params, self.k_draft, self.v_draft,
                dev[2 * bucket:].view(bucket, max_nb),
                dev[bucket:2 * bucket], dev[:bucket], self.draft_config)
            nxt = dl.argmax(-1).tolist()
            self._draft_s += time.perf_counter() - t0
            self.draft_steps += 1
            for i, seq in stepping:
                rid = seq.req.request_id
                seq.draft_pos += 1
                last_out[rid] = nxt[i]
                if seq.draft_pos > seq.n_cached:
                    proposals.setdefault(rid, []).append(nxt[i])
        # -- verify phase: one batched K+1-position base step; fed |
        # qstart | t_live | tables in one buffer, one copy each way
        T = K + 1
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
        dev = self._to_device(host)
        o = bucket * T
        out, clen, fin = self._base_step(
            llama_paged_verify_step, self.params, self.k_pool, self.v_pool,
            dev[o + 2 * bucket:].view(bucket, max_nb), dev[o:o + bucket],
            dev[o + bucket:o + 2 * bucket], dev[:o].view(bucket, T),
            self.config)
        got = torch.cat([out.flatten(), clen, fin.int()]).tolist()
        self._decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        out = [got[i * T:(i + 1) * T] for i in range(bucket)]
        clen = got[o:o + bucket]
        fin = got[o + bucket:o + 2 * bucket]
        if not all(fin[:n]):
            bad = [s.req.request_id for s, f in zip(rows, fin) if not f]
            raise RuntimeError(f"requests {bad}: non-finite decode logits")
        done: List[_Seq] = []
        now = self._now()
        for i, seq in enumerate(rows):
            self._spec_proposed += int(t_live[i]) - 1
            # accepted draft credit = commit_len - 1: the +1 is the
            # base's own correction/next token
            self._spec_accepted += max(0, clen[i] - 1)
            for j in range(clen[i]):
                seq.n_cached += 1
                seq.tokens.append(out[i][j])
                if seq.first_token_t is None:
                    seq.first_token_t = now
                seq.token_times.append(now)
                if seq.done():
                    # eos/max_new inside the window: later verified tokens
                    # come after the stop, and sequential decode never
                    # makes them
                    break
            # roll the draft back to the last verified position: its
            # cache past the accepted prefix reflects rejected tokens
            seq.draft_pos = min(seq.draft_pos, seq.n_cached)
            if seq.done():
                self._finish_seq(seq)
                done.append(seq)
        return done

    # -- driving loop -------------------------------------------------------

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
                if self.iteration >= max_iterations:
                    raise RuntimeError("engine exceeded max_iterations")
                self._clock = (float(self.iteration) if deterministic
                               else time.perf_counter() - t0)
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
                if not deterministic:
                    self._clock = time.perf_counter() - t0
        except BaseException:
            # leave a leak-free pool: every live sequence goes back to the
            # front of the waiting queue with its blocks released
            while self.active:
                seq = self.active.pop()
                self._release(seq)
                seq.state = WAITING
                seq.n_cached = 0
                self.waiting.insert(0, seq)
            raise
        return self.stats()

    def stats(self) -> Dict[str, Any]:
        """Throughput/latency aggregates over finished requests (engine
        clock: seconds in wall mode, iterations in deterministic mode),
        and the host-clock mean of each decode step and prefill chunk
        (each ends in the device->host copy of its sampled tokens, so
        the device work is inside it). With speculation on, a decode step
        is one verify step; ``speculative`` holds the proposal counts and
        the draft steps' own mean."""
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
        return {
            "requests": len(seqs),
            "unfinished": len(self.waiting) + len(self.active),
            "generated_tokens": gen,
            "elapsed_s": span,
            "tokens_per_sec": gen / span if span > 0 else None,
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "tpot_p50_s": pct(gaps, 50),
            "tpot_p99_s": pct(gaps, 99),
            "preemptions": self.preemptions,
            "iterations": self.iteration,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "decode_step_ms_mean": (self._decode_s * 1e3 / self.decode_steps
                                    if self.decode_steps else None),
            "prefill_chunk_ms_mean": (
                self._prefill_s * 1e3 / self.prefill_chunks
                if self.prefill_chunks else None),
            "speculative": ({
                "draft_k": self.serve.draft_k,
                "draft_layers": self.draft_config.num_hidden_layers,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "accept_rate": (self._spec_accepted / self._spec_proposed
                                if self._spec_proposed else None),
                "draft_steps": self.draft_steps,
                "draft_step_ms_mean": (self._draft_s * 1e3
                                       / self.draft_steps
                                       if self.draft_steps else None),
            } if self.serve.speculative else None),
            "pool_blocks": self.serve.num_blocks - 1,
            "used_blocks": self.pool.used_blocks,
            "kv_dtype": self.serve.kv_dtype,
            "device": str(self.device),
        }
