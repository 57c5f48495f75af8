"""Closed-loop MC predictives: one client sends a request, waits for its
mean, variance and entropy on the host, and sends the next.

Traffic parameters: ``batch`` (images a request), ``samples`` (S),
``pool`` (distinct input batches made on the device from the seed, used
in turn), ``keep_every`` (on average one request in this many keeps its
outputs for the check, drawn from the seed), ``check_requests`` (how many
of the kept requests the reference recomputes) and ``traced_requests``
(the requests under the profiler in a ``--trace 1`` run, after the
window).

The program is served as its users serve it: ``BayesEngine`` on the
model, the weights loaded once, ``compile(x, S)`` (a CUDA graph of one
predict), then ``predict(x, seed=...)`` a request, each request with a
seed of its own.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import trace, weights
from perfbench.reference.common import (Grid, Numerics, f32_mode,
                                        predictive, sample_pairs)

WARM_REQUESTS = 3
OUTPUTS = ("probs", "var", "entropy")
# what ``check`` can put in the program's place
CONTROLS = ("control",)


def request_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + i) % (1 << 63)


def build_model(cell):
    """The port's model of the configuration, on the CPU, unloaded."""
    from bayestpu_torch.core.config import BayesConfig, QuantConfig
    from bayestpu_torch.nn.zoo import get_model

    c = cell.config
    quant = QuantConfig(**c["quant"]) if c.get("quant") else None
    return get_model(c["model"], bayes=BayesConfig(rate=c["mc_rate"]),
                     fused=c["fused"], dtype=getattr(torch, c["dtype"]),
                     num_classes=c["num_classes"],
                     input_shape=tuple(c["input_shape"]), quant=quant,
                     n_exits=c["n_exits"], **c.get("model_kwargs", {}))


def params_of(cell, seed: int, device) -> dict:
    return weights.make_params(cell.reference.param_specs(cell.config), seed,
                               device, cell.config.get("init"))


def setup(cell, seed: int, device) -> SimpleNamespace:
    from bayestpu_torch.engine.engine import BayesEngine

    t = cell.traffic
    model = build_model(cell).to(device)
    model.load_state_dict(params_of(cell, seed, device), strict=True)
    engine = BayesEngine(model, model.bayes, device=device)
    engine.ready = True              # weights loaded in place of attach()
    pool = weights.make_images(seed, t["pool"], t["batch"],
                               cell.config["input_shape"], device)
    engine.compile(pool[0], t["samples"])
    for i in range(WARM_REQUESTS):
        p = engine.predict(pool[i % t["pool"]], seed=request_seed(~seed, i),
                           num_samples=t["samples"])
        [getattr(p, k).cpu() for k in OUTPUTS]
    keep = np.random.default_rng(seed & 0xFFFFFFFF).random(1 << 20)
    return SimpleNamespace(cell=cell, seed=seed, device=device,
                           engine=engine, model=model, pool=pool,
                           keep=keep < 1.0 / t["keep_every"], kept={})


def _request(st, i: int, span) -> tuple[float, float]:
    """Request i; returns its latency and the host time in ``predict``."""
    s = st.cell.traffic["samples"]
    x = st.pool[i % st.pool.shape[0]]
    t0 = time.perf_counter()
    with span("predict"):
        p = st.engine.predict(x, seed=request_seed(st.seed, i),
                              num_samples=s)
    t1 = time.perf_counter()
    with span("readback"):
        out = [getattr(p, k).cpu() for k in OUTPUTS]
    t2 = time.perf_counter()
    if i == 0 or (i < st.keep.size and st.keep[i]):
        st.kept[i] = out
    return t2 - t0, t1 - t0


def window(st, seconds: float, traced: bool) -> SimpleNamespace:
    lat, host, failed = [], [], 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i, now = 0, t_start
    while now < t_end:
        try:
            dt, dh = _request(st, i, trace.no_span)
            lat.append(dt)
            host.append(dh)
        except RuntimeError as err:      # a request the program refused
            failed += 1
            print(f"request {i} failed: {err}", flush=True)
        i += 1
        now = time.perf_counter()
    window_s = now - t_start
    rec = SimpleNamespace(kind="predict", window_s=window_s, attempted=i,
                          failed=failed, latencies_s=lat, host_predict_s=host,
                          requests=len(lat),
                          batch=st.cell.traffic["batch"],
                          samples=st.cell.traffic["samples"], trace=None)
    if traced:
        n0, n = i, st.cell.traffic["traced_requests"]

        def tail():
            for j in range(n0, n0 + 2):           # the profiler's first
                _request(st, j, trace.span)       # launches are often lost
            for j in range(n0 + 2, n0 + 2 + n):
                with trace.span(trace.UNIT):
                    _request(st, j, trace.span)

        rec.trace = trace.profiled(tail)
    return rec


def release(st) -> None:
    st.engine = st.model = None
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        torch.cuda.empty_cache()


def numerics(cell, control: bool) -> Numerics:
    """The reference's precision: the configuration's, or with
    ``control`` the one below it (fp8 for bf16; a narrower grid)."""
    q = cell.config.get("quant")
    if q:
        bits = cell.config["control_bits"] if control else q["total_bits"]
        return Numerics("f32", Grid(bits, q["integer_bits"]))
    return Numerics("fp8" if control else "f32")


def checked_requests(st, record) -> list[int]:
    """The kept requests that the window finished, a sample of them drawn
    from the seed, with request 0 in whenever it finished."""
    done = sorted(k for k in st.kept if k < record.attempted)
    first = done[:1] if done[:1] == [0] else []
    rest = done[len(first):]
    rng = np.random.default_rng((st.seed ^ 0x5EED) & 0xFFFFFFFF)
    n = st.cell.traffic["check_requests"] - len(first)
    pick = rng.choice(len(rest), size=min(n, len(rest)), replace=False)
    return first + sorted(rest[j] for j in pick)


def reference_outputs(st, idx: list[int], numerics: Numerics) -> dict:
    """The reference's predictive of requests ``idx``, on the device."""
    cell = st.cell
    f32_mode()
    params = params_of(cell, st.seed, st.device)
    sites = cell.reference.num_sites(cell.config)
    outs = {}
    with torch.no_grad():
        for i in idx:
            pairs = sample_pairs(request_seed(st.seed, i),
                                 cell.traffic["samples"], sites)
            logits = cell.reference.forward(
                params, st.pool[i % st.pool.shape[0]], pairs.to(st.device),
                cell.config, numerics)
            outs[i] = {k: v.cpu() for k, v in predictive(logits).items()}
    return outs


def gaps(got: dict, ref: dict) -> dict:
    """The widest gap of each output over the requests compared."""
    out = {}
    for k in OUTPUTS:
        out[k + "_gap"] = max(float((got[i][k] - ref[i][k]).abs().max())
                              for i in ref)
    return out


def check(st, record, control: str | None = None) -> dict:
    """The program's outputs of the checked requests against the
    reference's; with ``control="control"`` the reference at the precision
    below the configuration's in the program's place."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"no control {control!r} for a predict cell")
    idx = checked_requests(st, record)
    ref = reference_outputs(st, idx, numerics(st.cell, False))
    if control:
        got = reference_outputs(st, idx, numerics(st.cell, True))
    else:
        got = {i: dict(zip(OUTPUTS, st.kept[i])) for i in idx}
    return gaps(got, ref)
