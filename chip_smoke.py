#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bayestpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports nothing of JAX and
nothing of the JAX package. Each phase prints one JSON line; any failure
ends the run with a nonzero exit and no result line.

1. card    — ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build   — compiles every kernel of ``bayestpu_torch/csrc`` with nvcc.
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card: the vgg11_me head shape and a ragged one, bf16 and f32; exact mask
   readouts; per-sample bit identity; negative seeds; times.
4. slice   — vgg11_me at full width, bf16, batch 128, S=10, rate 0.25,
   seeded weights, through ``BayesEngine(device="cuda")``: spatial and
   temporal predictive and a host loop of one-sample predicts, with launch
   counts, agreement checks, a CPU reference on 8 rows, and times.
5. profile — device time by kernel over spatial predicts (torch.profiler).

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

MEM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # f32 outside the tensor cores
SOURCE = "bayestpu_torch/csrc/masked_matmul.cu"
REPLACES = {"dropout_matmul": "bayestpu/kernels/masked_matmul.py:113",
            "dropout_matmul_samples": "bayestpu/kernels/masked_matmul.py:286"}
HEAD = dict(M=128, K=512, N=10, S=10)     # each vgg11_me exit head
RAGGED = dict(M=300, K=700, N=130, S=3)
RATE = 0.25
BATCH, SAMPLES = 128, 10
# f32 accumulation runs in another order in the kernel and in torch.matmul;
# the products are exact on both sides (bf16 x bf16 fits f32), so the
# difference is a few ulps of the partial sums: relative to max|ref|
KERNEL_RTOL = 1e-5
# spatial vs temporal per-sample logits: the heads are bit-identical per
# sample; cuDNN may pick another conv algorithm from one call to the next
SPATIAL_TEMPORAL_ATOL = 1e-3
# card vs CPU on rows 0-7: bf16 convs round at other points in cuDNN and
# oneDNN (the port and JAX differ by ~0.005 on CPU logits of magnitude ~1.4)
CPU_REF_RTOL = 0.03


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int, windows: int = 5) -> float:
    """Median over ``windows`` of the CUDA-event time of ``iters`` calls,
    per call, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / iters)
    return statistics.median(per)


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the summed time of the CUDA kernels
    it launches, from torch.profiler over ``iters`` calls after a warm-up.
    Unlike ``cuda_ms`` it does not count the host's dispatch between
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if str(ev.device_type).endswith("CUDA"))
    check(us > 0, "the profiler saw no device time")
    return us / iters / 1e3


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def phase_card() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build() -> None:
    from bayestpu_torch.kernels import _build
    rep = _build.build_all()
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in rep["ptxas"].items()}
    emit({"phase": "build", "seconds": rep["seconds"], "built": rep["built"],
          "ptxas": regs})


def _inputs(shape: dict, dtype, gen):
    import torch
    m, k, n, s = shape["M"], shape["K"], shape["N"], shape["S"]
    x = torch.randn(m, k, generator=gen).to(dtype).cuda()
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(dtype).cuda()
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (s, 2), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    seeds[0] = torch.tensor([-123456789, -7], dtype=torch.int32)  # negative
    return x, w, seeds.cuda()


def _bound(name: str, shape: dict, dtype) -> tuple[float, str]:
    """Least time for the kernel's work on an H100: each input byte read
    once and each output byte written once over the HBM rate, or the
    matmul's FLOPs over the peak for the dtype, whichever is larger."""
    s = 1 if name == "dropout_matmul" else shape["S"]
    m, k, n = shape["M"], shape["K"], shape["N"]
    esize = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = esize * (m * k + k * n) + 4 * 2 * s + 4 * s * m * n
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = 2 * s * m * n * k / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels() -> dict:
    import torch
    from bayestpu_torch.kernels import masked_matmul as mm

    gen = torch.Generator().manual_seed(1234)
    summary = {name: {"max_abs_err": 0.0} for name in REPLACES}
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape in (("head", HEAD), ("ragged", RAGGED)):
            x, w, seeds = _inputs(shape, dtype, gen)
            line = {"phase": "kernels", "shape": label, **shape,
                    "dtype": str(dtype).split(".")[-1], "rate": RATE}
            # values against the plain versions on the same card tensors
            y1 = mm.dropout_matmul(x, w, seeds[0], RATE)
            r1 = mm.dropout_matmul_plain(x, w, seeds[0], RATE)
            ys = mm.dropout_matmul_samples(x, w, seeds, RATE)
            rs = mm.dropout_matmul_samples_plain(x, w, seeds, RATE)
            torch.cuda.synchronize()
            for name, y, r in (("dropout_matmul", y1, r1),
                               ("dropout_matmul_samples", ys, rs)):
                err = (y - r).abs().max().item()
                tol = KERNEL_RTOL * max(1.0, r.abs().max().item())
                check(err <= tol, f"{name} {label} {dtype}: {err} > {tol}")
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], err)
                line[f"{name}_max_abs_err"] = err
                line[f"{name}_tol"] = tol
            # sample s of the samples kernel == single kernel with seeds[s]
            same = all(torch.equal(ys[s], mm.dropout_matmul(
                x, w, seeds[s].contiguous(), RATE))
                for s in range(shape["S"]))
            check(same, f"samples vs single bit identity {label} {dtype}")
            line["samples_equal_single_bitwise"] = same
            line["negative_seed_sample0"] = seeds[0].tolist()
            # exact mask readout: ones @ eye(K) gives 0 or the dtype's 1/keep
            ones = torch.ones(shape["M"], shape["K"], dtype=dtype,
                              device="cuda")
            eye = torch.eye(shape["K"], dtype=dtype, device="cuda")
            a1 = mm.dropout_matmul(ones, eye, seeds[0], RATE)
            as_ = mm.dropout_matmul_samples(ones, eye, seeds, RATE)
            exact = (torch.equal(a1, mm.dropout_matmul_plain(
                ones, eye, seeds[0], RATE)) and torch.equal(
                as_, mm.dropout_matmul_samples_plain(ones, eye, seeds, RATE)))
            vals = sorted(set(as_.unique().tolist()))
            check(exact and vals == [0.0, mm.scale_of(RATE, dtype)],
                  f"mask readout {label} {dtype}: exact={exact} values={vals}")
            line["readout_bit_exact"] = exact
            line["readout_keep_fraction"] = (as_ != 0).float().mean().item()
            if label == "head":
                _time_kernels(mm, x, w, seeds, shape, dtype, line, summary)
            emit(line)
    return summary


def _time_kernels(mm, x, w, seeds, shape, dtype, line, summary) -> None:
    """Times at the head shape; the bf16 ones (the main path's dtype) go
    into the summary."""
    import torch
    s0 = seeds[0].contiguous()
    keep = mm.keep_mask(s0, shape["M"], shape["K"], RATE)
    scale = torch.tensor(mm.scale_of(RATE, dtype), dtype=dtype, device="cuda")
    xm1 = torch.where(keep, x * scale, torch.zeros((), dtype=dtype,
                                                   device="cuda"))
    xms = torch.stack([xm1] * shape["S"])
    timings = {
        "dropout_matmul": (
            lambda: mm.dropout_matmul(x, w, s0, RATE),
            lambda: mm.dropout_matmul_plain(x, w, s0, RATE),
            lambda: torch.matmul(xm1, w)),
        "dropout_matmul_samples": (
            lambda: mm.dropout_matmul_samples(x, w, seeds, RATE),
            lambda: mm.dropout_matmul_samples_plain(x, w, seeds, RATE),
            lambda: torch.matmul(xms, w)),
    }
    for name, (kern, plain, lib) in timings.items():
        # ms, plain_ms, library_ms: device time per call; events_ms: CUDA
        # events over back-to-back wrapper calls, host dispatch included
        t = {"ms": device_ms(kern, 200), "plain_ms": device_ms(plain, 20),
             "library_ms": device_ms(lib, 200),
             "events_ms": cuda_ms(kern, 200)}
        t["bound_ms"], t["bound_by"] = _bound(name, shape, dtype)
        line[name] = t
        if dtype == torch.bfloat16:
            summary[name].update(t)


def phase_slice() -> dict:
    import torch
    from bayestpu_torch.core.config import (BayesConfig, EngineConfig,
                                            SamplingMode)
    from bayestpu_torch.engine import sampler
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.kernels import masked_matmul as mm
    from bayestpu_torch.nn.zoo import get_model

    def build(mode: SamplingMode, device: str) -> BayesEngine:
        model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE),
                          fused=True, dtype=torch.bfloat16)
        return BayesEngine(model, config=EngineConfig(mode=mode),
                           device=device).init(0, x_cpu[:1])

    gen = torch.Generator().manual_seed(7)
    x_cpu = torch.randn(BATCH, 32, 32, 3, generator=gen)
    x = x_cpu.cuda()
    sp = build(SamplingMode.SPATIAL, "cuda")
    tm = build(SamplingMode.TEMPORAL, "cuda")
    seed = 11

    def host_loop():
        return sum(sp.predict(x, seed, sample_idx=i)
                   for i in range(SAMPLES)) / SAMPLES

    sp.predict(x, seed, SAMPLES)      # warm-up: cuDNN plans, allocator
    tm.predict(x, seed, SAMPLES)
    torch.cuda.synchronize()

    # ---- the main path, counted: spatial, temporal, host loop
    mm.reset_launch_counts()
    p_sp = sp.predict(x, seed, SAMPLES)
    torch.cuda.synchronize()
    after_sp = dict(mm.launch_counts)
    p_tm = tm.predict(x, seed, SAMPLES)
    torch.cuda.synchronize()
    after_tm = dict(mm.launch_counts)
    p_loop = host_loop()
    torch.cuda.synchronize()
    launches = dict(mm.launch_counts)
    n_heads = sp.model.num_sites
    check(n_heads == 5, f"vgg11_me has {n_heads} MC sites")
    check(after_sp == {"dropout_matmul": 0, "dropout_matmul_samples": 5},
          f"spatial predict launches {after_sp}")
    check(after_tm == {"dropout_matmul": 5 * SAMPLES,
                       "dropout_matmul_samples": 5},
          f"temporal predict launches {after_tm}")
    check(launches == {"dropout_matmul": 10 * SAMPLES,
                       "dropout_matmul_samples": 5},
          f"host loop launches {launches}")

    for name, p in (("spatial", p_sp.probs), ("temporal", p_tm.probs),
                    ("host_loop", p_loop)):
        check(p.shape == (5, BATCH, 10), f"{name} probs shape {p.shape}")
        check(bool(torch.isfinite(p).all()), f"{name} probs finite")
        dev = (p.sum(-1) - 1).abs().max().item()
        check(dev < 1e-5, f"{name} probs sum to 1 (off by {dev})")
    d_tm = (p_sp.probs - p_tm.probs).abs().max().item()
    d_loop = (p_sp.probs - p_loop).abs().max().item()
    check(d_tm < 1e-5 and d_loop < 1e-5,
          f"predictive probs: spatial vs temporal {d_tm}, host loop {d_loop}")

    # ---- per-sample logits: spatial vs temporal, and rows 0-7 vs the CPU
    with torch.inference_mode():
        seeds = sp.seeds(seed, SAMPLES)
        l_sp = sampler.mc_logits(sp.model, x, seeds, SamplingMode.SPATIAL)
        l_tm = sampler.mc_logits(sp.model, x, seeds, SamplingMode.TEMPORAL)
        cpu = build(SamplingMode.SPATIAL, "cpu")
        l_cpu = sampler.mc_logits(cpu.model, x_cpu[:8], seeds.cpu(),
                                  SamplingMode.SPATIAL)
    d_st = (l_sp - l_tm).abs().max().item()
    check(d_st <= SPATIAL_TEMPORAL_ATOL,
          f"spatial vs temporal logits {d_st} > {SPATIAL_TEMPORAL_ATOL}")
    d_cpu = (l_sp[:, :, :8].cpu() - l_cpu).abs().max().item()
    cpu_tol = CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item())
    check(d_cpu <= cpu_tol, f"card vs CPU rows 0-7: {d_cpu} > {cpu_tol}")

    # ---- times
    spatial_ms = host_ms(lambda: sp.predict(x, seed, SAMPLES), 30)
    temporal_ms = host_ms(lambda: tm.predict(x, seed, SAMPLES), 10)
    loop_ms = host_ms(host_loop, 10)
    emit({"phase": "slice", "model": "vgg11_me", "dtype": "bfloat16",
          "batch": BATCH, "samples": SAMPLES, "rate": RATE,
          "launches_main_path": launches,
          "launches_spatial_predict": after_sp,
          "spatial_vs_temporal_logits_max_abs": d_st,
          "spatial_temporal_bit_identical": bool(torch.equal(l_sp, l_tm)),
          "spatial_vs_temporal_probs_max_abs": d_tm,
          "spatial_vs_host_loop_probs_max_abs": d_loop,
          "card_vs_cpu_rows0_7_logits_max_abs": d_cpu,
          "card_vs_cpu_tol": cpu_tol,
          "spatial_p50_ms": spatial_ms,
          "mc_samples_per_s": BATCH * SAMPLES / (spatial_ms / 1e3),
          "temporal_p50_ms": temporal_ms,
          "host_loop_p50_ms": loop_ms,
          "final_exit_mean_max_prob":
              p_sp.probs[-1].max(-1).values.mean().item()})
    return {"launches": launches, "engine": sp, "x": x, "seed": seed}


def phase_profile(sl: dict) -> None:
    """Device time by kernel over spatial predicts, beside the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng, x, seed, reps = sl["engine"], sl["x"], sl["seed"], 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.predict(x, seed, SAMPLES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):      # kernels, not CPU ops
            rows.append((ev.self_device_time_total / reps / 1e3,
                         ev.count // reps, ev.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    groups: dict[str, list] = {}
    for ms, calls, key in rows:
        group = ("port kernels" if "dropout_matmul" in key else
                 "convolutions" if "fprop" in key or "conv" in key else
                 "other")
        g = groups.setdefault(group, [0.0, 0])
        g[0] += ms
        g[1] += calls
    emit({"phase": "profile", "what": "spatial predict, profiled",
          "wall_ms_per_predict": wall_ms,
          "device_ms_per_predict": dev_ms if rows else "not measured",
          "device_busy_share": dev_ms / wall_ms if rows else "not measured",
          "kernel_launches_per_predict": sum(r[1] for r in rows),
          "by_group": {k: {"ms": v[0], "launches": v[1]}
                       for k, v in groups.items()},
          "top": [{"ms": r[0], "calls": r[1], "kernel": r[2][:90]}
                  for r in rows[:12]]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a machine with an NVIDIA card", file=sys.stderr)
        return 1
    import bayestpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    summary = phase_kernels()
    sl = phase_slice()
    phase_profile(sl)
    kernels = []
    for name, stats in summary.items():
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": sl["launches"][name],
                        "max_abs_err": stats["max_abs_err"],
                        "ms": stats["ms"], "plain_ms": stats["plain_ms"],
                        "bound_ms": stats["bound_ms"],
                        "bound_by": stats["bound_by"],
                        "library_ms": stats["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
