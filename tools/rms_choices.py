"""Times the design choices of the RMSNorm kernel (csrc/rms_norm.cu, row 1)
against each other on one card.

    python3 tools/rms_choices.py [FORM ...]

Copies paddle_tpu_torch/ into a temporary directory once for each form
below, its kernel source edited as its entry in FORMS says: the shipped
form, and the forms it was chosen over (FORMs pick some; the shipped form
always runs):

  two_barriers      warp 0 sums the warps' partials and publishes the
                    total behind a second barrier (the parent's
                    block_sum), against every warp summing them itself
                    after one barrier;
  wide_512          blocks of up to 512 threads before NV grows (NV = 1
                    at H = 4096 in bf16), against 256;
  persistent        a persistent grid (the CTAs that fit the SMs at once,
                    each loading w once and walking rows by grid stride,
                    the next row's x in flight during the reduction),
                    against a CTA a row;
  persistent_no_prefetch, persistent_depth_3
                    that grid with no row in flight, or two;
  pdl               programmatic dependent launch (cudaLaunchKernelEx with
                    cudaLaunchAttributeProgrammaticStreamSerialization; w
                    loaded before griddepcontrol.wait, x after it).

Every copy builds at once, in a process of its own; then each copy runs
alone, in the order of FORMS and again in reverse, so that a drift of the
card over the call shows. A run holds the kernel to its plain version
(chip_smoke's ``check_rms``) and times it at [8, 4096], [256, 4096] and
[8192, 4096] bf16 beside the launch floor (an empty kernel,
``torch.cuda._sleep(0)``), device ms per call with 200 calls queued
ahead (chip_smoke's ``_time_ms``). Back-to-back launches flatter a form
that overlaps one launch with the next (pdl), so the shipped and pdl forms
also profile one llama_7b decode step and one prefill chunk (chip_smoke's
``profile_steps`` on seeded random weights, bf16 pools): the rms_norm
class's device ms (65 launches a decode step), the step's device ms and
its wall ms; a form is kept only if it wins there. ptxas's registers and
spills of each form's kernels are printed too. Needs one CUDA device and
nvcc; exits non-zero if a form fails its check; writes
chiprun_out/rms_choices.json.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ONE_BARRIER = """  __syncthreads();  // the one barrier: every warp then sums all partials itself
  const float total = warp_sum(lane < nw ? part[lane] : 0.f);
"""
_TWO_BARRIERS = """  __syncthreads();
  __shared__ float total_s;
  if (warp == 0) {
    const float t = warp_sum(lane < nw ? part[lane] : 0.f);
    if (lane == 0) total_s = t;
  }
  __syncthreads();
  const float total = total_s;
"""
_LOADS = """#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = tid + k * nt;
    wv[k] = i < nvec ? __ldg(wr + i) : zero;
    xv[k] = i < nvec ? __ldg(xr + i) : zero;
  }
"""
_PDL_LOADS = """#pragma unroll
  for (int k = 0; k < NV; ++k) wv[k] = tid + k * nt < nvec ? __ldg(wr + tid + k * nt) : zero;
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
  for (int k = 0; k < NV; ++k) xv[k] = tid + k * nt < nvec ? __ldg(xr + tid + k * nt) : zero;
"""
_LAUNCH = """  rms_norm_kernel<T, NV><<<n, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), h, eps);
  return cudaSuccess;
"""
_PDL_LAUNCH = """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rms_norm_kernel<T, NV>, static_cast<const T*>(x),
                            static_cast<const T*>(w), static_cast<T*>(out), h, eps);
"""
# The persistent form the shipped kernel beat: at most the CTAs that fit
# the SMs at once, each loading w once and walking rows r, r + grid, ...
# with the loads of x kDepth - 1 rows ahead issued before it reduces the
# current one; its kernel and launch in place of the shipped ones
_PERSISTENT = r"""constexpr int kDepth = 2;  // rows of x a CTA holds: the one it reduces, kDepth - 1 in flight

template <typename T, int NV>
__global__ void __launch_bounds__(NV < 8 ? kWideThreads : kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int n,
                    int h, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[2][kMaxThreads / 32];  // per row's warp partials, two rows apart
  const int nvec = h / VEC, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // row r's vectors of this thread, zeros past the row or the rows
  auto load_row = [=](uint4 (&v)[NV], int r) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * h);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = tid + k * nt;
      v[k] = r < n && i < nvec ? __ldg(xr + i) : zero;
    }
  };
  uint4 wv[NV], xs[kDepth][NV];
  const uint4* wr = reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = tid + k * nt;
    wv[k] = i < nvec ? __ldg(wr + i) : zero;
  }
#pragma unroll
  for (int s = 0; s + 1 < kDepth; ++s) load_row(xs[s], blockIdx.x + s * gridDim.x);
  int it = 0;
  for (int row = blockIdx.x; row < n;) {
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      if (row >= n) break;
      // the row kDepth - 1 ahead goes out before this row's reduction waits
      load_row(xs[(s + kDepth - 1) % kDepth], row + (kDepth - 1) * gridDim.x);
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) ss += sum_squares<T>(xs[s][k]);
      ss = warp_sum(ss);
      if (lane == 0) part[it & 1][warp] = ss;
      __syncthreads();  // the one barrier: row it + 2 reuses this half only after row it + 1's
      const float total = warp_sum(lane < nw ? part[it & 1][lane] : 0.f);
      const float inv = rsqrtf(total / (float)h + eps);
      uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * h);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = tid + k * nt;
        if (i < nvec) {
          uint4 o;
          const T* e = reinterpret_cast<const T*>(&xs[s][k]);
          const T* we = reinterpret_cast<const T*>(&wv[k]);
          T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int j = 0; j < VEC; ++j) oe[j] = from_f<T>(to_f(e[j]) * inv * to_f(we[j]));
          orow[i] = o;
        }
      }
      ++it;
      row += gridDim.x;
    }
  }
}

// CTAs of `threads` threads that fit one SM, and the SMs of the current
// device, both cached (one card per process in the port; a new device
// recomputes)
template <typename K>
int resident_ctas(K kernel, int threads) {
  static int device = -1, sms = 0, per_sm[kMaxThreads / 32 + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != device) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    for (int& p : per_sm) p = 0;
    device = dev;
  }
  int& p = per_sm[threads / 32];
  if (p == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, kernel, threads, 0) !=
                    cudaSuccess)
    return 0;
  return p * sms;
}

template <typename T, int NV>
cudaError_t launch_nv(const void* x, const void* w, void* out, int n, int h, float eps,
                      int threads, cudaStream_t stream) {
  const int fit = resident_ctas(rms_norm_kernel<T, NV>, threads);
  if (fit <= 0) return cudaErrorInvalidConfiguration;
  rms_norm_kernel<T, NV><<<n < fit ? n : fit, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), n, h, eps);
  return cudaSuccess;
}

"""
_KERNEL_FROM = "template <typename T, int NV>\n__global__ void __launch_bounds__"
_KERNEL_TO = "template <typename T>\ncudaError_t launch("


def _persistent(src):
    a = src.index(_KERNEL_FROM)
    b = src.index(_KERNEL_TO, a)
    return src[:a] + _PERSISTENT + src[b:]


_DEPTH = "constexpr int kDepth = 2;"

# name -> {"edits": edits of csrc/rms_norm.cu, "step": profile the steps}
FORMS = {
    "shipped": dict(step=True),
    "two_barriers": dict(edits=[(_ONE_BARRIER, _TWO_BARRIERS)]),
    "wide_512": dict(edits=[("constexpr int kWideThreads = 256;",
                             "constexpr int kWideThreads = 512;")]),
    "persistent": dict(edits=[_persistent]),
    "persistent_no_prefetch": dict(edits=[
        _persistent, (_DEPTH, _DEPTH.replace("2", "1"))]),
    "persistent_depth_3": dict(edits=[
        _persistent, (_DEPTH, _DEPTH.replace("2", "3"))]),
    "pdl": dict(step=True, edits=[(_LOADS, _PDL_LOADS), (_LAUNCH, _PDL_LAUNCH)]),
}


def _chip_smoke():
    sys.path.append(ROOT)
    import chip_smoke
    return chip_smoke


def build_one():
    """In a copy's process: build, print ptxas's lines as JSON."""
    chip_smoke = _chip_smoke()
    from paddle_tpu_torch import _build
    _build.build_all(["rms_norm"])
    print(json.dumps(chip_smoke.ptxas_lines(_build.BUILD_LOGS.get("rms_norm",
                                                                  ""))))


def run_one(name):
    """In a copy's process: check, time and profile, as one JSON line."""
    import traceback

    import torch
    cs = _chip_smoke()
    from paddle_tpu_torch.ops import rms_norm as rn
    assert not rn.__file__.startswith(ROOT), rn.__file__
    dev = torch.device("cuda", 0)
    try:
        cs.check_rms(dev, {})
        check = "passes"
    except AssertionError:
        check = "fails: " + traceback.format_exc(limit=1)[-600:]
    ms = {"launch floor": cs._time_ms(lambda: torch.cuda._sleep(0), 200)[0]}
    for n in (8, 256, cs.TRAIN_B * cs.TRAIN_S):
        x = torch.randn((n, 4096), device=dev, dtype=torch.bfloat16)
        w = torch.ones((4096,), device=dev, dtype=torch.bfloat16)
        ms[f"rms_norm [{n},4096]"] = cs._time_ms(
            lambda: rn.fused_rms_norm(x, w, 1e-5), 200)[0]
        del x, w
    steps = None
    if FORMS[name].get("step"):
        steps = profile_steps(cs, dev)
    print(json.dumps({"ok": check == "passes", "ms": ms, "steps": steps,
                      "check": check}))


def profile_steps(cs, dev):
    """chip_smoke's profile_steps on a bf16 llama_7b engine: per step the
    rms_norm class's device ms, the device ms and the wall ms."""
    import torch
    from paddle_tpu_torch import (InferenceEngine, ServeConfig,
                                  init_llama_params, llama_7b)
    cfg = llama_7b()
    params = init_llama_params(cfg, seed=cs.SEED, device=dev)
    eng = InferenceEngine(params, cfg, ServeConfig(
        block_size=128, num_blocks=129, max_batch=8, prefill_chunk=256,
        max_seq_len=2048), device=dev)
    out = {}
    for step, r in cs.profile_steps(eng, cfg, dev).items():
        out[step] = {"rms_norm_ms": r["by_class_ms"].get("rms_norm"),
                     "device_ms": r["device_ms"], "wall_ms": r["wall_ms"]}
    del eng, params
    torch.cuda.empty_cache()
    return out


def _run(args, copy):
    env = dict(os.environ, PYTHONPATH=copy)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + args, cwd=copy, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _last_json(name, p, timeout):
    stdout, stderr = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{name}: exit {p.returncode}\n{stderr[-4000:]}")
    return json.loads(stdout.strip().splitlines()[-1])


def main(names):
    unknown = set(names) - set(FORMS)
    if unknown:
        sys.exit(f"unknown forms {sorted(unknown)}; known: {list(FORMS)}")
    forms = {n: f for n, f in FORMS.items()
             if n == "shipped" or not names or n in names}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    tmp = tempfile.mkdtemp(prefix="rms_choices_")
    copies, procs = {}, []
    record = {"nvidia_smi": smi, "ptxas": {}, "runs": []}
    good = True
    try:
        for name, form in forms.items():
            copies[name] = os.path.join(tmp, name)
            pkg = os.path.join(copies[name], "paddle_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            cu = os.path.join(pkg, "csrc", "rms_norm.cu")
            src = open(cu).read()
            for edit in form.get("edits", []):
                if callable(edit):
                    src = edit(src)
                    continue
                old, new = edit
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            with open(cu, "w") as f:
                f.write(src)
        procs = [(name, _run(["--build"], copies[name])) for name in forms]
        for name, p in procs:
            record["ptxas"][name] = _last_json(name, p, 900)
            for line in record["ptxas"][name]:
                print(f"{name} ptxas {line}")
        for name in list(forms) + list(reversed(forms)):
            p = _run(["--one", name], copies[name])
            procs.append((name, p))
            run = dict(form=name, **_last_json(name, p, 900))
            record["runs"].append(run)
            good &= run["ok"]
            print(json.dumps({k: run[k] for k in ("form", "ok", "ms",
                                                  "steps")}))
            if not run["ok"]:
                print(f"{name} FAILED its check: {run['check']}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rms_choices.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    sys.exit(0 if good else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        build_one()
    elif sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
    else:
        main(sys.argv[1:])
