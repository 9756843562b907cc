"""Port parity: paddle_tpu_torch.observability (counters and spans,
LogHistogram, StepMetrics, RequestTracer, FlightRecorder, the exporters)
against paddle_tpu.observability on scripted inputs, plus the port's own
parts: spans open ``torch.profiler.record_function``, the peak table
knows the H100, memory stats come from the CUDA allocator (none on the
CPU), and the engine's telemetry leaves streams unchanged.
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import request_trace as jrt
from paddle_tpu.ops import _common

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import exporters as texp
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tmet
from paddle_tpu_torch.observability import request_trace as trt

from torch_serve_common import run_port, streams, tiny_model


def test_counters_roundtrip():
    obs.reset_counters()
    obs.record_counter("x.calls")
    obs.record_counter("x.calls", 2)
    obs.set_counter("x.flag", 7)
    assert obs.counters() == {"x.calls": 3.0, "x.flag": 7.0}
    obs.reset_counters()
    assert obs.counters() == {}


def test_comm_span_counts_and_opens_a_profiler_range():
    obs.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.comm_span("t.span", nbytes=64, site="t.site"):
            torch.ones(4).sum()
    c = obs.counters()
    assert c["t.span.calls"] == 1 and c["t.span.bytes"] == 64
    assert c["site.t.site.calls"] == 1 and c["site.t.site.bytes"] == 64
    assert c["site.t.site.ms"] >= 0
    assert "t.span" in {e.key for e in prof.key_averages()}
    obs.reset_counters()


def test_telemetry_knobs(monkeypatch, tmp_path):
    monkeypatch.delenv(obs.ENV_TELEMETRY, raising=False)
    assert not obs.telemetry_enabled() and obs.telemetry_enabled(True)
    monkeypatch.setenv(obs.ENV_TELEMETRY, "1")
    assert obs.telemetry_enabled() and not obs.telemetry_enabled(False)
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "0")  # JAX's: not ours
    assert obs.telemetry_enabled()
    monkeypatch.setenv(obs.ENV_TELEMETRY_DIR, str(tmp_path))
    assert obs.telemetry_dir() == str(tmp_path)


def _hist_script(mod):
    h = mod.LogHistogram(lo=1e-3, hi=1e3, bins_per_decade=8)
    for v in (0.0, 5e-4, 0.002, 0.002, 0.9, 1.0, 17.0, 250.0, 2e3, 2e3):
        h.record(v)
    o = mod.LogHistogram(lo=1e-3, hi=1e3, bins_per_decade=8)
    o.record(3.5)
    h.merge(o)
    return (h.to_dict(), h.snapshot((0, 25, 50, 90, 99, 100)),
            mod.render_prometheus({"lat": h, "g": 3, "none": None},
                                  prefix="p"),
            mod.histogram_sample_lines("x", h, labels='k="v"'))


def test_histogram_script_matches_jax():
    from paddle_tpu.observability import histogram as jhist
    from paddle_tpu_torch.observability import histogram as thist
    assert _hist_script(thist) == _hist_script(jhist)


def test_step_metrics_records_and_summary(tmp_path):
    path = str(tmp_path / "steps.jsonl")
    m = obs.StepMetrics(name="t", n_devices=2, peak_flops=1e12)
    m.attach(obs.JsonlWriter(path, flush_every=1))
    m.record_compile(compile_s=0.5, trace_s=0.1, flops=4e9)
    for _ in range(3):
        m.step(tokens=128)
    m.close()
    assert (m.compiles, m.recompiles, m.steps) == (1, 0, 3)
    recs = obs.load_jsonl(path)
    assert len(recs) == 3 and recs[0]["step_time_ms"] is None
    t_s = recs[1]["step_time_ms"] / 1e3
    np.testing.assert_allclose(recs[1]["mfu"], 4e9 / (t_s * 2e12), rtol=1e-6)
    s = m.summary()
    assert s["steps"] == 3 and s["compile_time_s"] == 0.5
    assert s["step_time_ms_best"] <= s["step_time_ms_mean"]
    assert "mem_bytes_in_use" not in s     # no card, no allocator stats
    assert any("StepMetrics[t]" in ln for ln in m.summary_lines())
    # the record keys are JAX's (a CPU run has no memory stats)
    j = jobs.StepMetrics(name="t", n_devices=2, peak_flops=1e12)
    j.record_compile(flops=4e9)
    assert list(m.records[-1]) == [k for k in j.step(tokens=1)
                                   if not k.startswith("mem_")]


@pytest.mark.parametrize("on", [False, True], ids=["knobs_off", "knobs_on"])
def test_step_metrics_summary_overlap_matches_jax(monkeypatch, on):
    """The summary's key set and its ``overlap`` flags are JAX's, with the
    tp and pp overlap knobs both off and both on."""
    value = "1" if on else "0"
    for name in ("TP_OVERLAP", "PP_OVERLAP"):
        monkeypatch.setenv(f"PADDLE_TPU_TORCH_{name}", value)
        monkeypatch.setenv(f"PADDLE_TPU_{name}", value)
    m = obs.StepMetrics(name="t", n_devices=2, peak_flops=1e12)
    j = jobs.StepMetrics(name="t", n_devices=2, peak_flops=1e12)
    for metrics in (m, j):
        metrics.record_compile(flops=4e9)
        for _ in range(3):
            metrics.step(tokens=128)
    got, want = m.summary(), j.summary()
    assert list(got) == [k for k in want if not k.startswith("mem_")]
    assert got["overlap"] == want["overlap"] == obs.overlap_flags() == {
        "tp.overlap_on": int(on), "pp.overlap_on": int(on)}


def test_step_metrics_recompile_and_registry():
    m = obs.StepMetrics(name="t", peak_flops=1e12)
    m.record_compile(flops=1e6)
    m.step()
    m.record_compile(flops=2e6)
    assert m.step()["step_time_ms"] is None and m.recompiles == 1
    reg = obs.MetricsRegistry(prefix="p")
    m.register_into(reg)
    assert "p_steps 2.0" in reg.render_prometheus()


def test_peak_flops_table(monkeypatch):
    from paddle_tpu.observability import metrics as jmet
    assert tmet.PEAK_FLOPS_TABLE == (("h100 80gb hbm3", 989e12),
                                     jmet.PEAK_FLOPS_TABLE[-1])
    monkeypatch.setenv(tmet.ENV_PEAK_FLOPS, "123.0")
    assert obs.peak_flops_per_device() == 123.0
    assert obs.peak_flops_info()[1] == "env"
    monkeypatch.delenv(tmet.ENV_PEAK_FLOPS)
    assert obs.peak_flops_info("cpu") == (100e9, "table:cpu")
    monkeypatch.setattr(tmet, "device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert obs.peak_flops_info() == (989e12, "table:h100 80gb hbm3")
    # other H100s have other peaks: they warn, not take the SXM's
    for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        monkeypatch.setattr(tmet, "device_name", lambda device=None: name)
        with pytest.warns(UserWarning, match=name.lower()):
            assert obs.peak_flops_info() == (None, f"unknown:{name.lower()}")
    monkeypatch.setattr(tmet, "device_name", lambda device=None: "Mystery")
    with pytest.warns(UserWarning, match="mystery"):
        assert obs.peak_flops_info() == (None, "unknown:mystery")
    assert obs.peak_flops_info()[0] is None       # warned once


def test_exporters(tmp_path):
    path = str(tmp_path / "a.jsonl")
    w = obs.JsonlWriter(path, flush_every=100)
    w.write({"a": 1, "x": np.float32(2.5), "arr": np.arange(2),
             "t": torch.tensor(1.5), "v": torch.arange(2)})
    w.flush()
    assert obs.load_jsonl(path) == [{"a": 1, "x": 2.5, "arr": [0, 1],
                                     "t": 1.5, "v": [0, 1]}]
    w.close()
    out = obs.write_chrome_trace(str(tmp_path / "t.json"),
                                 [{"name": "a", "ph": "i", "ts": 0}])
    assert json.load(open(out))["traceEvents"][0]["name"] == "a"
    assert texp.process_rank() == 0


def _tracer_script(mod):
    tr = mod.RequestTracer()
    tr.submit(0, 1.0)
    tr.submit(1, 1.5)
    tr.reject(2, 1.6, "queue_full")
    tr.phase("admit", 2.0, 2.1, 1)
    tr.admit(0, 2.1)
    tr.prefill_chunk(0, 2.1, 2.4, 32, recompute=False)
    tr.phase("prefill", 2.1, 2.4, 1)
    tr.decode([0], 2.4, 2.5, 1)
    tr.admit(1, 2.5)
    tr.evict(0, 2.6, 1)
    tr.prefill_chunk(1, 2.6, 2.8, 16, recompute=False)
    tr.decode([1], 2.8, 2.9, 2)
    tr.admit(0, 3.0, 1)
    tr.prefill_chunk(0, 3.0, 3.2, 33, recompute=True)
    tr.decode([0, 1], 3.2, 3.3, 3)
    tr.finish(1, 3.3, 3)
    tr.quarantine(0, 3.4, "non-finite decode logits")
    tr.submit(3, 3.5)
    tr.shed(3, 4.0, "deadline")
    events = tr.to_chrome_events()
    events[0]["args"]["name"] = "serve"        # the process name differs
    return (tr.spans, tr.request_ids(), tr.tree(0), tr.to_jsonl_records(),
            events, tr.span_count(), tr.span_count("decode"),
            mod.spans_overlap(tr.tree(1)["children"]))


def test_request_tracer_script_matches_jax(tmp_path):
    assert _tracer_script(trt) == _tracer_script(jrt)
    tr = trt.RequestTracer()
    tr.submit(0, 1.0)
    tr.admit(0, 1.5)
    p = tr.export_chrome(str(tmp_path / "trace.json"))
    assert json.load(open(p))["traceEvents"][0]["args"]["name"] == \
        "paddle_tpu_torch.serve"
    assert tr.export_jsonl(str(tmp_path / "r.jsonl"))


def _recorder_script(mod, out_dir):
    rec = mod.FlightRecorder(source="t", size=8, out_dir=out_dir)
    for i in range(1, 21):
        rec.record({"iteration": i, "tokens": i * 2})
    rec.record_compile("decode_1", 0.5)
    for _ in range(mod.MIN_SPIKE_SAMPLES + 4):
        assert rec.check_step_time(0.01) is None
    spike = rec.check_step_time(0.5)
    storms = [rec.note_eviction(i) for i in range(1, 41)]
    first = rec.dump("exception")
    again = rec.dump("exception")
    payload = mod.load_dump(first)
    payload.pop("wall_time")
    return (list(rec.ring), [a["kind"] for a in rec.anomalies],
            spike is not None, sum(p is not None for p in storms),
            again, payload["records"], payload["n_records"],
            [os.path.basename(p).split("-")[2] for p in rec.dumped])


def test_flight_recorder_script_matches_jax(tmp_path, monkeypatch):
    assert _recorder_script(tfr, str(tmp_path / "t")) == \
        _recorder_script(jfr, str(tmp_path / "j"))
    monkeypatch.delenv("PADDLE_TPU_TORCH_TELEMETRY_DIR", raising=False)
    rec = tfr.FlightRecorder(source="t")
    rec.record({"iteration": 1})
    assert rec.dump("exception") is None
    monkeypatch.setenv("PADDLE_TPU_TORCH_TELEMETRY_DIR", str(tmp_path / "d"))
    assert rec.dump("exception").startswith(str(tmp_path / "d"))


def test_flight_recorder_knobs(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_TORCH_FLIGHT_RECORDER", raising=False)
    assert not obs.flight_recorder_enabled()
    monkeypatch.setenv("PADDLE_TPU_TORCH_FLIGHT_RECORDER", "1")
    assert obs.flight_recorder_enabled()
    assert not obs.flight_recorder_enabled(False)
    monkeypatch.setenv("PADDLE_TPU_TORCH_FLIGHT_RECORDER_SIZE", "4")
    monkeypatch.setenv("PADDLE_TPU_TORCH_SPIKE_MAD", "3")
    rec = obs.FlightRecorder(source="t")
    assert (rec.size, rec.spike_mad) == (4, 3.0)


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def test_engine_telemetry_is_measurement_only(model, tmp_path, monkeypatch):
    """StepMetrics, the tracer and the recorder on: streams equal a bare
    run, every request has a trace, the step records carry the engine's
    fields, and the spans tallied the serve sites."""
    rng = np.random.RandomState(0)
    trace = [dict(prompt=rng.randint(1, 96, size=n).tolist(),
                  max_new_tokens=4, arrival=float(i))
             for i, n in enumerate((7, 40, 130))]
    serve = dict(block_size=128, num_blocks=10, max_batch=2,
                 prefill_chunk=32, max_seq_len=512)
    with _common.interpret_mode(True):
        bare = run_port(model, serve, trace)
    obs.reset_counters()
    m = obs.StepMetrics(name="serve")
    monkeypatch.setenv("PADDLE_TPU_TORCH_TRACE_REQUESTS", "1")
    eng = run_port(model, serve, trace, telemetry=m, flight_recorder=True)
    assert streams(eng) == streams(bare) and eng.events == bare.events
    assert eng.tracer.request_ids() == [0, 1, 2]
    assert eng.tracer.span_count("finish") == 3
    assert 0 < m.steps <= eng.iteration
    assert {"queue_depth", "batch_occupancy", "prefill_ms",
            "decode_ms"} <= set(m.records[-1])
    c = obs.counters()
    assert c["site.serve.prefill.calls"] == eng.stats()["prefill_chunks"]
    assert c["site.serve.decode.calls"] == eng.stats()["decode_steps"]
    assert c["serve.finish"] == 3
    assert eng.recorder.ring and eng.stats()["compiles"]
    obs.reset_counters()
