"""Registry of the port's ``PADDLE_TPU_TORCH_*`` environment knobs (port
of ``paddle_tpu/envs.py``).

Every environment variable the port reads is declared here once, with its
type, default, parser and a doc string, and read through :func:`get`, so a
junk value raises a ``ValueError`` naming the variable. The names carry
the ``PADDLE_TPU_TORCH_`` prefix: the JAX package reads ``PADDLE_TPU_*``
and the two share a process in the tests, so no knob of one may steer the
other.

Values are parsed on every :func:`get` call, never cached, so tests flip
knobs with ``monkeypatch.setenv``. :func:`raw` returns the unparsed string
(or None).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["Knob", "get", "raw", "knobs", "is_registered"]

PREFIX = "PADDLE_TPU_TORCH_"


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered environment variable."""
    name: str
    kind: str          # "bool" | "int" | "float" | "enum" | "str"
    default: Any       # the parsed value returned when the var is unset
    doc: str
    parse: Callable[[Optional[str]], Any]  # raw (or None) -> value; raises
    choices: Tuple[str, ...] = ()          # for kind == "enum"


_REGISTRY: Dict[str, Knob] = {}


def _register(name, kind, default, doc, parse, choices=()):
    if not name.startswith(PREFIX):
        raise ValueError(f"port knob {name!r} must start with {PREFIX!r}")
    knob = Knob(name=name, kind=kind, default=default, doc=doc,
                parse=parse, choices=choices)
    _REGISTRY[name] = knob
    return knob


def get(name: str):
    """Parsed, validated value of a registered knob (default when unset).

    Raises ``KeyError`` for unregistered names and ``ValueError`` (naming
    the variable) when the environment holds a junk value."""
    return _REGISTRY[name].parse(os.environ.get(name))


def raw(name: str) -> Optional[str]:
    """The unparsed environment string (None when unset) of a registered
    knob."""
    _REGISTRY[name]  # KeyError on unregistered names, same as get()
    return os.environ.get(name)


def knobs() -> Tuple[Knob, ...]:
    """All registered knobs, sorted by name."""
    return tuple(sorted(_REGISTRY.values(), key=lambda k: k.name))


def is_registered(name: str) -> bool:
    return name in _REGISTRY


# ---------------------------------------------------------------------------
# parser factories (each returned parser takes the raw string-or-None)
# ---------------------------------------------------------------------------

def _truthy(truthy_values, unset="0"):
    """Lenient boolean: membership in ``truthy_values`` after strip+lower;
    anything else is False."""
    def parse(value):
        return (value if value is not None else unset).strip().lower() \
            in truthy_values
    return parse


def _strict_bool(name):
    """Strict boolean: unset/''/falsey spellings -> False, truthy -> True,
    anything else raises naming the variable."""
    def parse(value):
        v = (value or "").strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("", "0", "false", "no", "off"):
            return False
        raise ValueError(
            f"{name}={v!r}: expected a boolean "
            "(1/0/true/false/yes/no/on/off)")
    return parse


def _positive_int(name, default, allow_auto=False):
    """Strictly positive int; '' / 'auto' mean None when ``allow_auto``."""
    def parse(value):
        if value is None:
            return default
        s = value.strip().lower()
        if allow_auto and s in ("", "auto"):
            return None
        try:
            v = int(s)
        except ValueError:
            raise ValueError(
                f"{name} must be a positive integer"
                + (" or 'auto'" if allow_auto else "") + f", got {value!r}")
        if v <= 0:
            raise ValueError(f"{name} must be positive, got {value!r}")
        return v
    return parse


def _positive_float(name, default):
    def parse(value):
        if value is None or not value.strip():
            return default
        try:
            v = float(value.strip())
        except ValueError:
            raise ValueError(
                f"{name} must be a number, got {value!r}")
        if v <= 0:
            raise ValueError(f"{name} must be positive, got {value!r}")
        return v
    return parse


def _enum(name, choices, default):
    def parse(value):
        mode = (value if value is not None else default).strip().lower()
        if mode not in choices:
            raise ValueError(
                f"{name} must be " + _spell(choices) + f", got {mode!r}")
        return mode
    return parse


def _spell(choices):
    if len(choices) == 2:
        return f"'{choices[0]}' or '{choices[1]}'"
    return "one of " + "/".join(choices)


# ---------------------------------------------------------------------------
# the registry: one _register() call per knob
# ---------------------------------------------------------------------------

_register(
    "PADDLE_TPU_TORCH_FLASH_BWD", "enum", "auto",
    doc="Dense flash backward path: 'auto' (the fused backward kernel at "
        "every length) or 'split' (the dK/dV pass, then the dQ pass). Read "
        "on every backward call.",
    parse=_enum("PADDLE_TPU_TORCH_FLASH_BWD", ("auto", "split"), "auto"),
    choices=("auto", "split"))

_register(
    "PADDLE_TPU_TORCH_PP_OVERLAP", "bool", False,
    doc="The overlapped pipeline schedule (parallel.pipeline): each "
        "stage posts the previous tick's output's hop before its compute "
        "and waits for it after, T = M + 2(S - 1) ticks. An explicit "
        "overlap_p2p wins. Read when a pipeline is built.",
    parse=_truthy(("1", "true", "on")))

_register(
    "PADDLE_TPU_TORCH_TP_OVERLAP", "bool", False,
    doc="Turn on the collective-matmul rings of tensor parallelism "
        "(parallel.collective_matmul): the decoder's gate/up -> down pair "
        "runs as one fused plan whose only collective is the down "
        "product's ring of point-to-point hops. Read on every forward.",
    parse=_truthy(("1", "true", "ring", "on")))

_register(
    "PADDLE_TPU_TORCH_TP_OVERLAP_MIN_CHUNK", "int", 64,
    doc="Smallest ring chunk (token rows, or a column block's width) a "
        "plan issues; below it the plan returns None and the blocking "
        "collective runs. Also the auto chunker's target rows per sub-tile "
        "at mp > 2. Positive integer.",
    parse=_positive_int("PADDLE_TPU_TORCH_TP_OVERLAP_MIN_CHUNK", 64))

_register(
    "PADDLE_TPU_TORCH_TP_OVERLAP_CHUNKS", "int", None,
    doc="Explicit sub-tile count of each ring hop at mp > 2; ''/'auto' "
        "targets about MIN_CHUNK rows a sub-tile.",
    parse=_positive_int("PADDLE_TPU_TORCH_TP_OVERLAP_CHUNKS", None,
                        allow_auto=True))

_register(
    "PADDLE_TPU_TORCH_TELEMETRY", "bool", False,
    doc="Step-level telemetry switch: StepMetrics interval timing, spans "
        "and counters. An explicit telemetry argument wins over the env.",
    parse=_truthy(("1", "true", "on", "yes")))

_register(
    "PADDLE_TPU_TORCH_TELEMETRY_DIR", "str", None,
    doc="Directory for the JSONL step log and flight-recorder dumps; "
        "unset/empty means no file output.",
    parse=lambda value: value or None)

_register(
    "PADDLE_TPU_TORCH_PEAK_FLOPS", "float", None,
    doc="Per-device peak FLOP/s override for MFU; unset falls back to "
        "observability.metrics.PEAK_FLOPS_TABLE, matched on the card's "
        "name.",
    parse=_positive_float("PADDLE_TPU_TORCH_PEAK_FLOPS", None))

_register(
    "PADDLE_TPU_TORCH_TRACE_REQUESTS", "bool", False,
    doc="Request-lifecycle tracing in the serving engine: per-request span "
        "trees (queue wait, prefill chunks, decode iterations, evictions) "
        "exportable as JSONL and Chrome trace JSON. Measurement only: "
        "tokens are bit-identical on/off. InferenceEngine(trace_requests=) "
        "wins.",
    parse=_strict_bool("PADDLE_TPU_TORCH_TRACE_REQUESTS"))

_register(
    "PADDLE_TPU_TORCH_FLIGHT_RECORDER", "bool", False,
    doc="Failure flight recorder: a bounded ring of the last N iteration "
        "records in the engine, dumped to PADDLE_TPU_TORCH_TELEMETRY_DIR on "
        "exception, eviction storm or step-time spike. An explicit "
        "flight_recorder= argument wins over the env.",
    parse=_strict_bool("PADDLE_TPU_TORCH_FLIGHT_RECORDER"))

_register(
    "PADDLE_TPU_TORCH_FLIGHT_RECORDER_SIZE", "int", 256,
    doc="Ring capacity (records) of the flight recorder; also bounds the "
        "step-time window of its spike detector. Positive integer.",
    parse=_positive_int("PADDLE_TPU_TORCH_FLIGHT_RECORDER_SIZE", 256))

_register(
    "PADDLE_TPU_TORCH_SPIKE_MAD", "float", 8.0,
    doc="Step-time spike threshold of the flight recorder, in robust "
        "sigmas (MAD x 1.4826) from the window median. Positive number.",
    parse=_positive_float("PADDLE_TPU_TORCH_SPIKE_MAD", 8.0))

_register(
    "PADDLE_TPU_TORCH_FAULTS", "bool", False,
    doc="Gate of the fault-injection harness (paddle_tpu_torch.testing."
        "faults): arming a point raises unless this is set. Disarmed hooks "
        "cost one flag check.",
    parse=_strict_bool("PADDLE_TPU_TORCH_FAULTS"))

_register(
    "PADDLE_TPU_TORCH_SERVE_MAX_QUEUE", "int", None,
    doc="Bounded waiting-queue depth of the serving engine's admission "
        "control: submit() rejects with cause 'queue_full' once this many "
        "requests wait. ''/'auto'/unset means 4 x max_batch; "
        "ServeConfig(max_queue=) wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_SERVE_MAX_QUEUE", None,
                        allow_auto=True))

_register(
    "PADDLE_TPU_TORCH_SERVE_RATE", "float", None,
    doc="Token-bucket admission rate, in requests per engine-clock unit "
        "(seconds in wall mode, iterations in deterministic replay). "
        "Unset/empty disables rate limiting; ServeConfig(rate_limit=) wins.",
    parse=_positive_float("PADDLE_TPU_TORCH_SERVE_RATE", None))

_register(
    "PADDLE_TPU_TORCH_SERVE_BURST", "int", None,
    doc="Token-bucket burst capacity of serve admission. ''/'auto'/unset "
        "means max(2, max_batch); ServeConfig(burst=) wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_SERVE_BURST", None,
                        allow_auto=True))

_register(
    "PADDLE_TPU_TORCH_SERVE_OVERCOMMIT", "float", 4.0,
    doc="submit() rejects with cause 'overcommit' when the worst-case block "
        "demand of everything queued and active plus the new request "
        "exceeds this factor times the usable pool. Positive number; "
        "ServeConfig(overcommit=) wins.",
    parse=_positive_float("PADDLE_TPU_TORCH_SERVE_OVERCOMMIT", 4.0))

_register(
    "PADDLE_TPU_TORCH_SERVE_NAN_CHECK", "bool", True,
    doc="Per-row non-finite logit screen (on the device): a request whose "
        "prefill/decode logits hold NaN/Inf is quarantined while the rest "
        "of the batch keeps serving. Default ON; ServeConfig(nan_check=) "
        "wins.",
    parse=_truthy(("1", "true", "yes", "on"), unset="1"))

_register(
    "PADDLE_TPU_TORCH_SERVE_JOURNAL", "str", None,
    doc="Path of the serving engine's crash-recoverable request/token "
        "journal (append-only JSONL); a fresh engine's recover() re-drives "
        "to the same streams. Unset/empty disables it; "
        "InferenceEngine(journal=) wins.",
    parse=lambda value: value or None)

_register(
    "PADDLE_TPU_TORCH_SERVE_JOURNAL_FSYNC", "bool", False,
    doc="fsync the serve journal at each flush for power-failure "
        "durability; default flushes to the OS only.",
    parse=_strict_bool("PADDLE_TPU_TORCH_SERVE_JOURNAL_FSYNC"))

_register(
    "PADDLE_TPU_TORCH_SERVE_PREFIX_CACHE", "bool", False,
    doc="Copy-on-write prefix caching: prefilled prompts' full KV blocks "
        "stay indexed by their exact token prefix, and a later request "
        "whose prompt starts identically shares them and skips their "
        "prefill. Default OFF; ServeConfig(prefix_cache=) wins.",
    parse=_strict_bool("PADDLE_TPU_TORCH_SERVE_PREFIX_CACHE"))

_register(
    "PADDLE_TPU_TORCH_SERVE_KV_DTYPE", "enum", "auto",
    doc="Paged KV storage dtype: 'auto' (the model dtype) or 'int8' "
        "(codes with f32 per-column scale pools). ServeConfig(kv_dtype=) "
        "wins.",
    parse=_enum("PADDLE_TPU_TORCH_SERVE_KV_DTYPE", ("auto", "int8"), "auto"),
    choices=("auto", "int8"))

_register(
    "PADDLE_TPU_TORCH_SERVE_SPEC", "bool", False,
    doc="Greedy speculative decoding: a draft model proposes up to K "
        "tokens per row per iteration and one batched verify step scores "
        "K+1 positions. Streams equal sequential decode. Default OFF; "
        "ServeConfig(speculative=) wins.",
    parse=_strict_bool("PADDLE_TPU_TORCH_SERVE_SPEC"))

_register(
    "PADDLE_TPU_TORCH_SERVE_SPEC_K", "int", 4,
    doc="Draft proposal depth K of speculative serving (K+1 positions "
        "verified per row per iteration). ServeConfig(draft_k=) wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_SERVE_SPEC_K", 4))


_register(
    "PADDLE_TPU_TORCH_CKPT_KEEP", "int", 3,
    doc="Rolling-checkpoint retention of CheckpointManager: the keep-N "
        "garbage collector deletes complete step dirs beyond the newest "
        "N. Positive integer; an explicit keep= argument wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_CKPT_KEEP", 3))

_register(
    "PADDLE_TPU_TORCH_CKPT_INTERVAL", "int", None,
    doc="Steps between CheckpointManager.on_step async saves; "
        "''/'auto'/unset disables interval pacing (explicit save() calls "
        "only). An explicit interval= argument wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_CKPT_INTERVAL", None,
                        allow_auto=True))

_register(
    "PADDLE_TPU_TORCH_PREEMPT_GRACE", "float", 30.0,
    doc="Seconds a preemption shutdown waits for the in-flight async "
        "checkpoint write before abandoning it and taking the final sync "
        "save. Positive number.",
    parse=_positive_float("PADDLE_TPU_TORCH_PREEMPT_GRACE", 30.0))

_register(
    "PADDLE_TPU_TORCH_SERVE_MP", "int", 1,
    doc="Tensor-parallel degree of the serving engine: mp > 1 runs the "
        "paged prefill, decode and speculative verify steps over mp "
        "ranks, one process each (init_parallel_env), weights sliced per "
        "param_pspecs and the KV, scale and draft pools by kv head, with "
        "greedy streams equal to mp=1's. Needs num_attention_heads, "
        "num_key_value_heads, vocab_size and intermediate_size divisible "
        "by mp and a process group of mp ranks. ServeConfig(mp=) wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_SERVE_MP", 1))

_register(
    "PADDLE_TPU_TORCH_FLEET_SERVE_REPLICAS", "int", 2,
    doc="Replica count of the serving FleetRouter: N InferenceEngine "
        "replicas behind one prefix-affinity router. Positive integer; "
        "FleetRouter(n_replicas=) wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_FLEET_SERVE_REPLICAS", 2))

_register(
    "PADDLE_TPU_TORCH_FLEET_SERVE_SPILL", "int", 4,
    doc="Queue-depth spill threshold of the FleetRouter's prefix-affinity "
        "dispatch: when the affinity replica's queue depth + in-flight "
        "count reaches this, the request spills to the least-loaded live "
        "replica instead. Positive integer; FleetRouter(spill=) wins.",
    parse=_positive_int("PADDLE_TPU_TORCH_FLEET_SERVE_SPILL", 4))

_register(
    "PADDLE_TPU_TORCH_FLEET_SERVE_JOURNAL_DIR", "str", None,
    doc="Directory for per-replica FleetRouter journals: each replica "
        "writes replica_<i>.jsonl there, and kill_replica() re-drives a "
        "dead replica's unfinished journal entries onto survivors. "
        "Unset/empty disables fleet journaling; FleetRouter(journal_dir=) "
        "wins.",
    parse=lambda value: value or None)


def _parse_moe_dropless(value):
    v = (value or "").strip().lower()
    if v in ("1", "true", "yes", "on"):
        return "ragged"
    if v in ("", "0", "false", "no", "off"):
        return "capacity"
    raise ValueError(
        f"PADDLE_TPU_TORCH_MOE_DROPLESS={v!r}: expected a boolean "
        "(1/0/true/false/yes/no/on/off)")


_register(
    "PADDLE_TPU_TORCH_MOE_A2A", "enum", "ring",
    doc="Transport of the ragged all-to-all expert dispatch "
        "(parallel.moe.moe_ragged_dispatch_a2a): 'ring' sends each "
        "destination's chunk over n-1 shifted hops, 'dense' the same "
        "chunks through one equal-chunk all-to-all. Both give the same "
        "bits. Read on every MoE layer.",
    parse=_enum("PADDLE_TPU_TORCH_MOE_A2A", ("ring", "dense"), "ring"),
    choices=("ring", "dense"))

_register(
    "PADDLE_TPU_TORCH_MOE_A2A_OVERLAP", "bool", False,
    doc="Overlap the ragged dispatch's ring hops with the expert "
        "products: hop h+1 is posted before chunk h's grouped matmuls, "
        "instead of every hop landing before the first one. The same "
        "bits either way. Read on every MoE layer.",
    parse=_strict_bool("PADDLE_TPU_TORCH_MOE_A2A_OVERLAP"))

_register(
    "PADDLE_TPU_TORCH_MOE_DROPLESS", "enum", "capacity",
    doc="MoE dispatch default when neither the step nor the config names "
        "one: truthy selects the ragged dropless grouped-matmul path, "
        "falsy/unset the capacity slot schedule.",
    parse=_parse_moe_dropless,
    choices=("capacity", "ragged"))
