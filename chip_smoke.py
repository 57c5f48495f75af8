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
   readouts (the backward's mask is the forward's); per-sample bit
   identity; negative seeds; times.
4. backward — autograd through ``dropout_matmul`` against
   ``dropout_matmul_vjp_plain`` at the head shape.
5. slice   — vgg11_me at full width, bf16, batch 128, S=10, rate 0.25,
   seeded weights, through ``BayesEngine(device="cuda")``: spatial and
   temporal predictive and a host loop of one-sample predicts, with launch
   counts, agreement checks, a CPU reference on 8 rows, and times.
6. profile — device time by kernel over spatial predicts (torch.profiler).
7. train   — vgg11_me at full width, bf16, batch 128, rate 0.25 on 10,000
   hard synthetic CIFAR-10 images: 12 epochs (936 steps, as ``bench.py``
   trains the flagship) of ``create_state`` + ``make_train_step`` (SGD 0.9,
   cosine LR 0.05, clip 10) with launch counts, step times, throughput and
   profiled steps, one epoch of ``train_loop``
   with validation on a fresh model, then the trained weights served
   through ``BayesEngine`` (acc, ECE, NLL, aPE on 2,000 test images).
8. step_vs_cpu — one training step at batch 8 on the card and on the CPU
   from one seeded init and the same seeds, in f32 and bf16.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. The kernels' launches are those of the
two main paths: the slice's predicts and the 936 training steps.
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
            "dropout_matmul_samples": "bayestpu/kernels/masked_matmul.py:286",
            "dropout_apply": "bayestpu/kernels/masked_matmul.py:135"}
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
# backward on the card against its plain version on the same tensors: the
# f32 products are the same torch.matmul calls on both sides; under bf16 dx
# and dw are rounded to bf16 at the end, so allow one bf16 ulp (2^-7
# relative) should a sum round the other way
BWD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TRAIN_EPOCHS, TRAIN_LR, TRAIN_CLIP = 12, 0.05, 10.0    # bench.py:54,68,106
# one training step, card against CPU, from one init and one set of seeds.
# f32 (TF32 off): cuDNN and oneDNN sum in other orders, and BatchNorm over a
# batch of 8 amplifies a rounding difference several hundredfold (the CPU
# port and JAX differ by ~6e-5 relative in f32 gradients at batch 4), so
# each parameter update (new - old) must agree to 1% of its norm, the loss
# to 1e-4 and the BN running statistics to 1e-4 of their norm. bf16: the
# convs round to bf16 at other points, which BN amplifies to tens of
# percent in some gradients (JAX's own bf16 gradients differ from its f32
# ones by up to 60% of their norm at batch 4): the loss to 1%, the BN
# statistics to 5%, the head updates to 50% of their norm.
STEP_TOL = {"float32": dict(loss=1e-4, stats=1e-4, update=1e-2),
            "bfloat16": dict(loss=1e-2, stats=5e-2, update=0.5)}


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
    operations over the peak for their type, whichever is larger. The
    matmuls do 2·S·M·N·K FLOPs in the dtype; dropout_apply reads x and the
    seeds, writes (M, K) f32 and does M·K f32 multiplies."""
    m, k, n = shape["M"], shape["K"], shape["N"]
    esize = 2 if str(dtype).endswith("bfloat16") else 4
    if name == "dropout_apply":
        t_bytes = (esize * m * k + 4 * 2 + 4 * m * k) / MEM_BYTES_PER_S
        t_ops = m * k / PEAK_FLOPS["float32"]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")
    s = 1 if name == "dropout_matmul" else shape["S"]
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
            _check_apply(mm, x, seeds, ones, a1, dtype, label, line, summary)
            if label == "head":
                _time_kernels(mm, x, w, seeds, shape, dtype, line, summary)
            emit(line)
    return summary


def _check_apply(mm, x, seeds, ones, fwd_readout, dtype, label, line,
                 summary) -> None:
    """dropout_apply (the backward's mask) on the card: bit-equal to its
    plain version with each seed pair (the first negative), its readout of
    ones exactly {0, f32(1/(1-rate))}, and the readout's nonzero pattern
    equal to the forward kernel's ``ones @ eye``."""
    import torch
    same = True
    for s in range(seeds.shape[0]):
        sd = seeds[s].contiguous()
        same &= torch.equal(mm.dropout_apply(x, sd, RATE),
                            mm.dropout_apply_plain(x, sd, RATE))
    check(same, f"dropout_apply vs plain {label} {dtype}")
    r = mm.dropout_apply(ones, seeds[0].contiguous(), RATE)
    vals = sorted(set(r.unique().tolist()))
    same_mask = torch.equal(r != 0, fwd_readout != 0)
    check(vals == [0.0, mm.apply_scale(RATE)] and same_mask,
          f"dropout_apply readout {label} {dtype}: values {vals}, "
          f"forward mask {same_mask}")
    line["dropout_apply_bit_equal_plain"] = same
    line["dropout_apply_mask_equals_forward"] = same_mask
    line["dropout_apply_readout_values"] = vals
    summary["dropout_apply"]["max_abs_err"] = 0.0     # bit-equal


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
    # the yardstick of dropout_apply: one elementwise product with a
    # pre-made f32 mask (bf16 x promotes to f32 inside the one kernel)
    mask_scaled = keep.float() * mm.apply_scale(RATE)
    timings = {
        "dropout_matmul": (
            lambda: mm.dropout_matmul(x, w, s0, RATE),
            lambda: mm.dropout_matmul_plain(x, w, s0, RATE),
            lambda: torch.matmul(xm1, w)),
        "dropout_matmul_samples": (
            lambda: mm.dropout_matmul_samples(x, w, seeds, RATE),
            lambda: mm.dropout_matmul_samples_plain(x, w, seeds, RATE),
            lambda: torch.matmul(xms, w)),
        "dropout_apply": (
            lambda: mm.dropout_apply(x, s0, RATE),
            lambda: mm.dropout_apply_plain(x, s0, RATE),
            lambda: torch.mul(x, mask_scaled)),
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
    check(after_sp == {"dropout_matmul": 0, "dropout_matmul_samples": 5,
                       "dropout_apply": 0},
          f"spatial predict launches {after_sp}")
    check(after_tm == {"dropout_matmul": 5 * SAMPLES,
                       "dropout_matmul_samples": 5, "dropout_apply": 0},
          f"temporal predict launches {after_tm}")
    check(launches == {"dropout_matmul": 10 * SAMPLES,
                       "dropout_matmul_samples": 5, "dropout_apply": 0},
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


def _profile_rows(prof, reps: int) -> list:
    """(ms per rep, launches per rep, kernel name) of every CUDA kernel
    seen by the profiler (not the CPU ops), largest first."""
    rows = [(ev.self_device_time_total / reps / 1e3, ev.count // reps, ev.key)
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")]
    return sorted(rows, reverse=True)


def _by_group(rows: list) -> dict:
    """Device ms and launches by kind of kernel: the port's own, cuDNN
    convolutions (forward, data and weight gradients), cuBLAS matmuls,
    PyTorch reductions, PyTorch elementwise and copy kernels, the rest."""
    groups: dict[str, dict] = {}
    for ms, calls, key in rows:
        k = key.lower()
        group = ("port kernels" if "dropout_" in k else
                 "convolutions" if any(w in k for w in (
                     "fprop", "dgrad", "wgrad", "conv")) else
                 "matmuls" if "gemm" in k or "cutlass" in k else
                 "reductions" if "reduce_kernel" in k else
                 "elementwise" if "elementwise" in k or "copy" in k else
                 "other")
        g = groups.setdefault(group, {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += calls
    return groups


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
    rows = _profile_rows(prof, reps)
    dev_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "what": "spatial predict, profiled",
          "wall_ms_per_predict": wall_ms,
          "device_ms_per_predict": dev_ms if rows else "not measured",
          "device_busy_share": dev_ms / wall_ms if rows else "not measured",
          "kernel_launches_per_predict": sum(r[1] for r in rows),
          "by_group": _by_group(rows),
          "top": [{"ms": r[0], "calls": r[1], "kernel": r[2][:90]}
                  for r in rows[:12]]})


def phase_backward() -> None:
    """torch.autograd through dropout_matmul on the card against
    dropout_matmul_vjp_plain on the same card tensors, at the head shape:
    one forward launch and two dropout_apply launches per backward, dx
    exactly 0 wherever the mask drops."""
    import torch
    from bayestpu_torch.kernels import masked_matmul as mm
    gen = torch.Generator().manual_seed(99)
    m, k, n = HEAD["M"], HEAD["K"], HEAD["N"]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        x, w, seeds = _inputs(HEAD, dtype, gen)
        s0 = seeds[0].contiguous()                   # negative seeds
        g = torch.randn(m, n, generator=gen).cuda()
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        before = dict(mm.launch_counts)
        dx, dw = torch.autograd.grad(mm.dropout_matmul(xr, wr, s0, RATE),
                                     (xr, wr), g)
        torch.cuda.synchronize()
        launched = {kk: mm.launch_counts[kk] - before[kk] for kk in before}
        px, pw = mm.dropout_matmul_vjp_plain(x, w, s0, RATE, g)
        line = {"phase": "backward", "shape": "head", **HEAD,
                "dtype": name, "rate": RATE, "launches": launched}
        for what, got, ref in (("dx", dx, px), ("dw", dw, pw)):
            err = (got.float() - ref.float()).abs().max().item()
            tol = BWD_RTOL[name] * ref.float().abs().max().item()
            check(got.dtype == ref.dtype == dtype and err <= tol,
                  f"backward {what} {name}: {err} > {tol}")
            line[f"{what}_max_abs_err"] = err
            line[f"{what}_tol"] = tol
        keep = mm.keep_mask(s0, m, k, RATE)
        dropped_zero = bool((dx[~keep] == 0).all())
        check(dropped_zero, f"backward dx nonzero where dropped {name}")
        check(launched == {"dropout_matmul": 1, "dropout_matmul_samples": 0,
                           "dropout_apply": 2},
              f"backward launches {launched}")
        line["dx_zero_where_dropped"] = dropped_zero
        emit(line)




def phase_train() -> dict:
    """The training slice: vgg11_me at full width, bf16, batch 128, rate
    0.25, the flagship recipe of ``bench.py:106-108`` (SGD 0.9, cosine LR
    from 0.05 over the run, clip 10), on 10,000 hard synthetic CIFAR-10
    images, every epoch in the same batch order, as the JAX bench."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.data.datasets import get_dataset, iterate_batches
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.kernels import masked_matmul as mm
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import (create_state, make_train_step,
                                           train_loop)

    def build():
        return get_model("vgg11_me", bayes=BayesConfig(rate=RATE),
                         fused=True, dtype=torch.bfloat16)

    def flagship_tx(total_steps: int):
        return optim.chain(optim.clip_by_global_norm(TRAIN_CLIP), optim.sgd(
            optim.cosine_decay_schedule(TRAIN_LR, total_steps), 0.9))

    t0 = time.perf_counter()
    ds = get_dataset("cifar10", synth_difficulty="hard")
    data_s = time.perf_counter() - t0
    nb = len(ds.x_train) // BATCH
    steps = TRAIN_EPOCHS * nb
    xs = torch.from_numpy(ds.x_train[:nb * BATCH]).cuda().reshape(
        (nb, BATCH) + ds.x_train.shape[1:])
    ys = torch.from_numpy(ds.y_train[:nb * BATCH]).long().cuda().reshape(
        nb, BATCH)
    seed = 0
    model = build()
    tx = flagship_tx(steps)
    state = create_state(model, tx, seed, ds.x_train[:BATCH])
    step = make_train_step(model, tx)
    seeds = step_seeds(seed, range(steps), model.num_sites).cuda()
    losses, step_ms, first_step = [], [], {}

    def run(idx, timed: bool) -> None:
        for i in idx:
            t = time.perf_counter()
            losses.append(step(state, xs[i % nb], ys[i % nb],
                               seeds[i])["loss"])
            if i == 0:
                first_step.update(mm.launch_counts)
            if timed:
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)

    # ---- the main path, counted: 2 epochs of make_train_step
    # epoch 1 untimed; epoch 2 timed step by step (host clock ending in a
    # synchronise), but for three profiled steps a little way in; epochs
    # 3.. run free and give the throughput
    prof_steps, p0 = 3, nb + min(20, nb // 2)
    mm.reset_launch_counts()
    t_train = time.perf_counter()
    run(range(0, nb), False)
    run(range(nb, p0), True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(range(p0, p0 + prof_steps), False)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3 / prof_steps
    run(range(p0 + prof_steps, 2 * nb), True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(range(2 * nb, steps), False)
    torch.cuda.synchronize()
    free_s = time.perf_counter() - t
    train_s = time.perf_counter() - t_train
    launches = dict(mm.launch_counts)
    check(first_step == {"dropout_matmul": 5, "dropout_matmul_samples": 0,
                         "dropout_apply": 10},
          f"launches of one training step {first_step}")
    check(launches == {"dropout_matmul": 5 * steps,
                       "dropout_matmul_samples": 0,
                       "dropout_apply": 10 * steps},
          f"training launches {launches} over {steps} steps")
    loss = torch.stack(losses).float().cpu().numpy()
    check(bool(np.isfinite(loss).all()), "training loss finite")
    first10, last10 = float(loss[:10].mean()), float(loss[-10:].mean())
    check(last10 < first10, f"training loss fell: {first10} -> {last10}")
    rows = _profile_rows(prof, prof_steps)
    dev_ms = sum(r[0] for r in rows)
    check(dev_ms > 0, "the profiler saw no device time in a training step")
    p50 = statistics.median(step_ms)
    emit({"phase": "train", "model": "vgg11_me", "dtype": "bfloat16",
          "batch": BATCH, "rate": RATE, "epochs": TRAIN_EPOCHS,
          "steps": steps, "lr": TRAIN_LR, "clip": TRAIN_CLIP,
          "data": "cifar10 synthetic hard" if ds.meta["synthetic"]
          else "cifar10 files", "data_seconds": data_s,
          "launches_main_path": launches,
          "launches_per_step": {kk: v / steps for kk, v in launches.items()},
          "train_seconds": train_s,
          "train_step_p50_ms": p50,
          "train_step_min_ms": min(step_ms), "timed_steps": len(step_ms),
          "train_images_per_s": (steps - 2 * nb) * BATCH / free_s,
          "train_images_per_s_of_p50": BATCH / (p50 / 1e3),
          "profiled_step_wall_ms": prof_wall_ms,
          "device_ms_per_step": dev_ms,
          "device_busy_share": dev_ms / prof_wall_ms,
          "device_busy_share_of_p50": dev_ms / p50,
          "kernel_launches_per_step": sum(r[1] for r in rows),
          "by_group": _by_group(rows),
          "top": [{"ms": r[0], "calls": r[1], "kernel": r[2][:90]}
                  for r in rows[:12]],
          "first_loss": float(loss[0]), "final_loss": float(loss[-1]),
          "first10_mean_loss": first10, "last10_mean_loss": last10,
          "epoch_mean_loss": loss.reshape(TRAIN_EPOCHS, nb).mean(1).tolist()})

    # ---- train_loop, as the CLI trains: one epoch with validation on a
    # fresh model, reshuffled, counted on its own
    model2 = build()
    tx2 = flagship_tx(nb)
    state2 = create_state(model2, tx2, 1, ds.x_train[:BATCH])
    hist: dict = {}
    n_val = 4
    mm.reset_launch_counts()
    t = time.perf_counter()
    train_loop(model2, state2, tx2,
               lambda: iterate_batches(ds.x_train, ds.y_train, BATCH, seed=1),
               1, 1, val_batches=lambda: iterate_batches(
                   ds.x_test[:250 * n_val], ds.y_test[:250 * n_val], 250,
                   shuffle=False),
               reshuffle=True, history=hist, log_fn=lambda msg: None)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    loop_launches = dict(mm.launch_counts)
    check(loop_launches == {"dropout_matmul": 5 * (nb + n_val),
                            "dropout_matmul_samples": 0,
                            "dropout_apply": 10 * nb},
          f"train_loop launches {loop_launches}")
    check(state2.step == nb and len(hist["train_loss"]) == 1
          and np.isfinite(hist["train_loss"][0]),
          f"train_loop history {hist}")
    emit({"phase": "train_loop", "epochs": 1, "steps": state2.step,
          "val_batches": n_val, "seconds": loop_s,
          "launches": loop_launches, "history": hist})

    # ---- the trained weights, served
    eng = BayesEngine(build(), device="cuda").attach(state.variables())
    x_te, y_te = ds.x_test[:2000], ds.y_test[:2000]
    t = time.perf_counter()
    mets = eng.evaluate(x_te, y_te, seed=0, num_samples=SAMPLES)
    eval_s = time.perf_counter() - t
    check(all(np.isfinite(v) for v in mets.values()),
          f"trained metrics finite {mets}")
    mm.reset_launch_counts()
    pred = eng.predict(x_te[:BATCH], 0, SAMPLES)
    torch.cuda.synchronize()
    serve_launches = dict(mm.launch_counts)
    check(serve_launches == {"dropout_matmul": 0, "dropout_matmul_samples": 5,
                             "dropout_apply": 0},
          f"spatial predict of the trained weights {serve_launches}")
    check(pred.probs.shape == (5, BATCH, 10)
          and bool(torch.isfinite(pred.probs).all()), "trained predictive")
    emit({"phase": "trained_eval", "test_images": len(x_te),
          "samples": SAMPLES, "seconds": eval_s, **mets,
          "spatial_predict_launches": serve_launches,
          "final_exit_mean_max_prob":
              pred.probs[-1].max(-1).values.mean().item()})
    return {"launches": launches}


def phase_step_vs_cpu() -> None:
    """One training step at batch 8 on the card and on the CPU, from one
    seeded init and the same step seeds (STEP_TOL has the tolerances)."""
    import numpy as np
    import torch
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import create_state, make_train_step

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((8, 32, 32, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=8))
    heads = [f"exit{i}.linear.kernel" for i in range(1, 5)] + [
        "classifier.kernel"]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        res = {}
        for dev in ("cuda", "cpu"):
            model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE),
                              fused=True, dtype=dtype)
            tx = optim.chain(optim.clip_by_global_norm(TRAIN_CLIP), optim.sgd(
                optim.cosine_decay_schedule(TRAIN_LR, 10), 0.9))
            state = create_state(model, tx, 3, x, device=dev)
            before = {kk: p.detach().cpu().clone()
                      for kk, p in model.named_parameters()}
            m = make_train_step(model, tx)(
                state, x.to(dev), y.to(dev),
                step_seeds(3, 0, model.num_sites).to(dev))
            res[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        {kk: p.detach().cpu() - before[kk]
                         for kk, p in model.named_parameters()},
                        {kk: b.detach().cpu()
                         for kk, b in model.named_buffers()})
        (lc, nc, uc, bc), (lr, nr, ur, br) = res["cuda"], res["cpu"]
        tol = STEP_TOL[name]
        total = torch.sqrt(sum((u * u).sum() for u in ur.values())).item()

        def rel(a, b, floor=0.0):
            return (a - b).norm().item() / (b.norm().item() + floor)

        loss_rel = abs(lc - lr) / abs(lr)
        stats_rel = max(rel(bc[kk], br[kk]) for kk in br)
        upd = {kk: rel(uc[kk], ur[kk], 1e-3 * total) for kk in ur}
        gated = upd if name == "float32" else {kk: upd[kk] for kk in heads}
        worst = max(gated, key=gated.get)
        check(loss_rel <= tol["loss"] and stats_rel <= tol["stats"]
              and gated[worst] <= tol["update"],
              f"card vs CPU step {name}: loss {loss_rel}, stats {stats_rel},"
              f" update {worst} {gated[worst]} (tolerances {tol})")
        emit({"phase": "step_vs_cpu", "dtype": name, "batch": 8,
              "loss_card": lc, "loss_cpu": lr, "loss_rel": loss_rel,
              "grad_norm_card": nc, "grad_norm_cpu": nr,
              "bn_stats_max_rel": stats_rel,
              "head_update_rel": {kk: upd[kk] for kk in heads},
              "worst_update_rel": [worst, gated[worst]],
              "worst_any_update_rel": max(upd.values()), "tol": tol})


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
    phase_backward()
    sl = phase_slice()
    phase_profile(sl)
    tr = phase_train()
    phase_step_vs_cpu()
    kernels = []
    for name, stats in summary.items():
        launches = sl["launches"][name] + tr["launches"][name]
        check(launches > 0, f"{name} was never launched on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches,
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
