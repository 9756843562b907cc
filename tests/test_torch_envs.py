"""The port's knob registry (paddle_tpu_torch.envs) against the JAX
package's (paddle_tpu.envs): the same parsers and messages under the
``PADDLE_TPU_TORCH_`` prefix, one knob per name the port reads, and no
name shared with the JAX package, so a knob of one never steers the
other."""
import pytest

from paddle_tpu import envs as jenvs

from paddle_tpu_torch import envs
from paddle_tpu_torch.ops import flash_attention as fa

PORT_READS = {
    "FLASH_BWD", "TELEMETRY", "TELEMETRY_DIR", "PEAK_FLOPS",
    "TRACE_REQUESTS", "FLIGHT_RECORDER", "FLIGHT_RECORDER_SIZE",
    "SPIKE_MAD", "FAULTS", "SERVE_MAX_QUEUE", "SERVE_RATE", "SERVE_BURST",
    "SERVE_OVERCOMMIT", "SERVE_NAN_CHECK", "SERVE_JOURNAL",
    "SERVE_JOURNAL_FSYNC", "SERVE_PREFIX_CACHE", "SERVE_KV_DTYPE",
    "SERVE_SPEC", "SERVE_SPEC_K", "SERVE_MP", "MOE_DROPLESS", "MOE_A2A",
    "MOE_A2A_OVERLAP", "CKPT_KEEP",
    "CKPT_INTERVAL", "PREEMPT_GRACE", "FLEET_SERVE_REPLICAS",
    "FLEET_SERVE_SPILL", "FLEET_SERVE_JOURNAL_DIR", "PP_OVERLAP", "TP_OVERLAP",
    "TP_OVERLAP_MIN_CHUNK", "TP_OVERLAP_CHUNKS"}


def test_registry_holds_the_port_knobs_and_no_jax_name():
    names = [k.name for k in envs.knobs()]
    assert names == sorted(names)
    assert {n[len(envs.PREFIX):] for n in names} == PORT_READS
    assert not set(names) & {k.name for k in jenvs.knobs()}
    for k in envs.knobs():
        jk = jenvs._REGISTRY["PADDLE_TPU_" + k.name[len(envs.PREFIX):]]
        assert (k.kind, k.default, k.choices) == \
            (jk.kind, jk.default, jk.choices), k.name
    with pytest.raises(ValueError, match="PADDLE_TPU_TORCH_"):
        envs._register("PADDLE_TPU_X", "bool", False, "", lambda v: v)
    with pytest.raises(KeyError):
        envs.get("PADDLE_TPU_TORCH_NOPE")


JUNK = {"bool": "maybe", "int": "-3", "float": "fast", "enum": "sideways"}
# knobs whose enum value is spelled otherwise: MOE_DROPLESS reads a boolean
GOOD = {"MOE_DROPLESS": "1"}


@pytest.mark.parametrize("knob", envs.knobs(), ids=lambda k: k.name)
def test_each_knob_parses_like_jax(knob, monkeypatch):
    """Unset gives the default; a value set by monkeypatch parses as the
    JAX package's same knob parses it; junk raises naming the variable
    (the lenient booleans read junk as off, as in the JAX package)."""
    jname = "PADDLE_TPU_" + knob.name[len(envs.PREFIX):]
    monkeypatch.delenv(knob.name, raising=False)
    monkeypatch.delenv(jname, raising=False)
    assert envs.get(knob.name) == knob.default == jenvs.get(jname)
    assert envs.raw(knob.name) is None and envs.is_registered(knob.name)
    good = GOOD.get(knob.name[len(envs.PREFIX):]) or {
        "bool": "1", "int": "5", "float": "2.5", "str": "/x/y",
        "enum": (knob.choices[-1] if knob.choices else "")}[knob.kind]
    for value in (good, " On ", ""):
        monkeypatch.setenv(knob.name, value)
        monkeypatch.setenv(jname, value)
        try:
            want = jenvs.get(jname)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                envs.get(knob.name)
            assert str(got.value) == str(e).replace(jname, knob.name)
        else:
            assert envs.get(knob.name) == want
    monkeypatch.setenv(knob.name, good)
    monkeypatch.setenv(jname, JUNK.get(knob.kind, good))
    assert envs.get(knob.name) == envs.get(knob.name)   # JAX's not read
    if knob.kind in JUNK:
        monkeypatch.setenv(knob.name, JUNK[knob.kind])
        monkeypatch.setenv(jname, JUNK[knob.kind])
        try:
            jenvs.get(jname)
        except ValueError:
            with pytest.raises(ValueError, match=knob.name):
                envs.get(knob.name)


def test_flash_bwd_reads_through_the_registry(monkeypatch):
    assert fa.ENV_FLASH_BWD == "PADDLE_TPU_TORCH_FLASH_BWD"
    monkeypatch.delenv(fa.ENV_FLASH_BWD, raising=False)
    assert fa.dense_bwd_mode() == "auto"
    monkeypatch.setenv(fa.ENV_FLASH_BWD, " Split ")
    assert fa.dense_bwd_mode() == "split"
    monkeypatch.setenv(fa.ENV_FLASH_BWD, "fused")
    with pytest.raises(ValueError, match="PADDLE_TPU_TORCH_FLASH_BWD must "
                                         "be 'auto' or 'split'"):
        fa.dense_bwd_mode()
