"""BayesEngine — the init/compile/predict/evaluate/profile facade of the
port.

Counterpart of ``bayestpu/engine/engine.py``. The engine owns the model on
one device, which is ``"cuda"`` unless the caller asks for the CPU; it
raises when asked for a card that is not there, and never falls back.
Inputs are NHWC images (numpy or torch); seeds are integers from which
``core.rng.sample_seeds`` derives every MC mask. A Masksembles model
enumerates its masks: S is ``num_masks`` and sample *i* runs mask *i*.
``evaluate`` can add the OOD check (aPE on gaussian noise images).

``compile`` is the JAX engine's AOT compile: on a card it captures one
predict at a fixed input shape and S into a CUDA graph, which ``predict``
replays for that shape and S. ``autotune`` times the spatial mapping
against the temporal one and adopts the faster; ``benchmark`` times the
served predict; ``evaluate_repeated``, ``compare`` and ``cost_analysis``
follow the JAX engine's keys. With a ``mesh`` (``engine.sharding``)
``predict`` runs the sharded predictive: the samples over the mesh's sample
axis, the batch over its data axis, every rank returning the whole
batch's predictive; the other methods keep their one-process paths, as in
JAX.
"""

from __future__ import annotations

import gc
import time
from typing import Any

import numpy as np
import torch

from bayestpu_torch.core.config import BayesConfig, EngineConfig, SamplingMode
from bayestpu_torch.core.rng import fold_seed, sample_seeds
from bayestpu_torch.engine import sampler, sharding
from bayestpu_torch.engine.sampler import Predictive
from bayestpu_torch.interop.from_flax import load_flax_variables
from bayestpu_torch.metrics.ece import eval_metrics
from bayestpu_torch.metrics.entropy import (mean_predictive_entropy,
                                            random_noise_data,
                                            random_noise_like)
from bayestpu_torch.utils.profiler import (NO_SPAN, count, device_events,
                                          graph_spans, span)

# the seed of the OOD noise generator (the JAX engine's jax.random.key(99))
NOISE_SEED = 99
# the predicts ``cost_analysis`` profiles (their mean is reported)
PROFILED_PREDICTS = 5


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class BayesEngine:
    """Executable wrapper around a port model for MC inference."""

    def __init__(self, model: torch.nn.Module,
                 bayes: BayesConfig | None = None,
                 config: EngineConfig = EngineConfig(),
                 device: str | torch.device = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        self.bayes = bayes if bayes is not None else getattr(
            model, "bayes", BayesConfig())
        self.config = config
        self.ready = False
        # (input shape, S) → the captured predict (``compile``)
        self._graphs: dict[tuple, "_Graph"] = {}
        self._tuned: dict | None = None   # autotune report (mode=AUTO)

    # ------------------------------------------------------------ lifecycle

    def init(self, seed: int, sample_input: Any) -> "BayesEngine":
        """Fresh parameters from Flax's initializers, drawn from ``seed``."""
        x = self._input(sample_input)
        if tuple(x.shape[1:]) != self.model.input_shape:
            raise ValueError(f"sample_input {tuple(x.shape)} does not fit "
                             f"the model's input {self.model.input_shape}")
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.ready = True
        return self

    def attach(self, variables: Any) -> "BayesEngine":
        """Weights from a JAX variables tree (nested dicts of numpy
        arrays); see ``interop.from_flax``."""
        load_flax_variables(self.model, variables)
        self.ready = True
        return self

    def _mode(self) -> SamplingMode:
        if self.config.mode is SamplingMode.AUTO:
            # an untuned AUTO runs spatial, as the JAX engine does
            return (SamplingMode.SPATIAL if self._tuned is None
                    else SamplingMode(self._tuned["mode"]))
        return self.config.mode

    def _input(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def seeds(self, seed: int, num_samples: int) -> torch.Tensor:
        """(S, n_sites, 2) int32 MC seeds on the engine's device."""
        return sample_seeds(seed, num_samples, self.model.num_sites).to(
            self.device)

    # ------------------------------------------------------------ inference

    def _predict_fn(self, mode: SamplingMode | None = None):
        """The predict of ``mode`` (default the engine's) as a function of
        the input and the (S, n_sites, 2) seeds."""
        mode = self._mode() if mode is None else mode
        if mode is SamplingMode.TEMPORAL:
            return lambda x, seeds: sampler.mc_moments(self.model, x, seeds)
        return lambda x, seeds: sampler.predictive(self.model, x, seeds,
                                                   SamplingMode.SPATIAL)

    @torch.inference_mode()
    def autotune(self, sample_input: Any, num_samples: int | None = None,
                 iters: int = 12) -> dict:
        """Time the spatial against the temporal mapping for this model,
        batch and S, and adopt the faster for later compiles and predicts
        (``engine.py:104-146``): three alternating windows of each
        (``utils.timing.paired_compare``: CUDA events on a card, the host
        clock on the CPU), decided by the median per-pair ratio. Returns
        ``mode``, ``timings_s`` (the two times of the median pair),
        ``paired``, ``num_samples`` and ``input_shape``."""
        from bayestpu_torch.utils.timing import paired_compare

        s = sampler.num_effective_samples(self.bayes, num_samples)
        x = self._input(sample_input)
        seeds = self.seeds(0, s)
        sp, tm = SamplingMode.SPATIAL.value, SamplingMode.TEMPORAL.value
        f_sp = self._predict_fn(SamplingMode.SPATIAL)
        f_tm = self._predict_fn(SamplingMode.TEMPORAL)
        cmp = paired_compare(lambda: f_sp(x, seeds), lambda: f_tm(x, seeds),
                             self.device, iters=iters, labels=(sp, tm))
        self._tuned = {"mode": cmp["winner"],
                       "timings_s": {sp: cmp[f"median_{sp}_s"],
                                     tm: cmp[f"median_{tm}_s"]},
                       "paired": cmp, "num_samples": s,
                       "input_shape": tuple(x.shape)}
        return dict(self._tuned)

    @torch.inference_mode()
    def compile(self, sample_input: Any, num_samples: int | None = None
                ) -> dict:
        """Prepare the predict of ``sample_input``'s shape at S samples (≙
        ``compileHlsModel``; the JAX engine's AOT compile,
        ``engine.py:148-164``). With ``mode=AUTO`` the mapping is measured
        first (``autotune``).

        On a card the predict of the engine's mapping is captured into a
        ``torch.cuda.CUDAGraph``: it runs twice eagerly on a side stream
        first (the kernels build at first use, and cuDNN and cuBLAS set
        up; none of that may happen inside a capture), then once under
        capture on static input and seed buffers. ``predict`` replays the
        graph whenever the shape and S match, with the same kernels in the
        same order as an eager predict, so the replayed predictive equals
        the eager one bit for bit. Weights that ``init``/``attach`` load
        later are copied into the captured tensors, so replays see them. A
        capture that fails raises; nothing falls back to eager.

        On a CPU engine there is nothing to capture: the shape is recorded
        and ``predict`` runs eagerly. Returns ``compile_seconds`` (capture,
        warm-up and any first-use kernel build), ``num_samples``,
        ``input_shape`` and ``mode``."""
        if not self.ready:
            raise RuntimeError("engine not initialized: call init()/attach()")
        s = sampler.num_effective_samples(self.bayes, num_samples)
        if self.config.mode is SamplingMode.AUTO and self._tuned is None:
            self.autotune(sample_input, s)
        x = self._input(sample_input)
        t0 = time.perf_counter()
        graph = (_Graph.capture(self._predict_fn(), x, self.seeds(0, s),
                                _has_device_spans(self.model))
                 if self.device.type == "cuda" else None)
        dt = time.perf_counter() - t0
        self._graphs[(tuple(x.shape), s)] = graph
        return {"compile_seconds": dt, "num_samples": s,
                "input_shape": tuple(x.shape), "mode": self._mode().value}

    @torch.inference_mode()
    def predict(self, x: Any, seed: int = 0, num_samples: int | None = None,
                sample_idx: int | None = None
                ) -> Predictive | torch.Tensor:
        """MC-averaged predictive distribution over ``num_samples`` samples
        (a Masksembles model: over its ``num_masks`` masks), or with
        ``sample_idx`` the per-exit softmax (E, B, C) of that one sample —
        for Masksembles the fork's ``predict(x, mask_index=i)`` — which
        equals sample ``sample_idx`` of the MC average. A predict whose
        shape and S were compiled on a card replays the captured graph and
        returns copies of its outputs. With a mesh the sharded predictive
        runs (ahead of any captured graph, as in JAX), over S padded to a
        multiple of the sample axis, which it reports. Under a profiler a
        predictive records the spans ``engine.predict``, ``engine.seeds``
        and, replayed, ``engine.launch`` and ``engine.outputs``; the
        counters ``engine.graph_replays`` and ``engine.eager_predicts``
        always count (``utils.profiler``)."""
        if not self.ready:
            raise RuntimeError("engine not initialized: call init()/attach()")
        if sample_idx is not None:
            if sample_idx < 0:
                raise ValueError(f"sample_idx must be >= 0; got {sample_idx}")
            x = self._input(x)
            seeds = self.seeds(seed, sample_idx + 1)[sample_idx]
            return torch.softmax(self.model(x, seeds, sample_idx).logits,
                                 dim=-1)
        with span("engine.predict", self.device.type == "cuda") as root:
            x = self._input(x)
            s = sampler.num_effective_samples(self.bayes, num_samples)
            graph = (None if self.mesh is not None
                     else self._graphs.get((tuple(x.shape), s)))
            if graph is not None:
                count("engine.graph_replays")
                with span("engine.seeds"):
                    seeds = sample_seeds(seed, s, self.model.num_sites)
                if graph.timed and root is not NO_SPAN:   # spans record
                    graph = graph.instrumented()
                return graph.replay(x, seeds, root)
            count("engine.eager_predicts")
            n = (s if self.mesh is None
                 else sharding.padded_samples(s, self.mesh))
            with span("engine.seeds"):
                seeds = self.seeds(seed, n)
            root.stop_clock()
            if self.mesh is not None:
                return sharding.sharded_predictive(self.model, x, seeds,
                                                   self.mesh)
            return self._predict_fn()(x, seeds)

    def _noise_for(self, x: torch.Tensor, dataset: str | None
                   ) -> torch.Tensor:
        """OOD probe inputs of x's shape: with ``dataset``, the reference's
        fixed per-dataset stats; without, x's own mean and std."""
        gen = torch.Generator().manual_seed(NOISE_SEED)
        if dataset is not None:
            return random_noise_data(gen, dataset, tuple(x.shape)).to(
                self.device)
        noise = random_noise_like(gen, tuple(x.shape)).to(self.device)
        return x.mean() + x.std(correction=0) * noise

    @torch.inference_mode()
    def evaluate(self, x: Any, y: Any, seed: int = 0,
                 num_samples: int | None = None, ood_check: bool = False,
                 dataset: str | None = None) -> dict[str, float]:
        """acc / NLL / MSE / ECE / aPE of the final exit's MC predictive,
        fetched from the device in one transfer. ``ood_check`` adds
        ``aPE_ood``, the aPE on gaussian noise images of x's shape drawn
        with the same seed's masks (``engine.py:221-260``); ``dataset``
        names the benchmark whose fixed noise stats to use."""
        x = self._input(x)
        probs = self.predict(x, seed, num_samples).probs[-1]
        labels = torch.as_tensor(y, dtype=torch.int64, device=self.device)
        mets = eval_metrics(probs, labels)
        mets["aPE"] = mean_predictive_entropy(probs)
        if ood_check:
            noise = self._noise_for(x, dataset)
            mets["aPE_ood"] = mean_predictive_entropy(
                self.predict(noise, seed, num_samples).probs[-1])
        values = torch.stack([v.float() for v in mets.values()]).tolist()
        return dict(zip(mets, values))

    @torch.inference_mode()
    def evaluate_repeated(self, x: Any, y: Any, passes: int = 10,
                          seed: int = 0, num_samples: int | None = None,
                          ood_check: bool = False,
                          log_path: str | None = None,
                          dataset: str | None = None) -> dict:
        """Mean and population std (ddof 0) of the ``evaluate`` battery
        over ``passes`` passes, pass p at the seed ``fold_seed(seed, p)``
        (``engine.py:262-301``), one pass at a time, so the memory is that
        of one pass. Keys: each metric, ``<metric>_std`` and ``passes``;
        with ``log_path`` the same as ``name: value`` lines."""
        x = self._input(x)
        runs = [self.evaluate(x, y, fold_seed(seed, p), num_samples,
                              ood_check, dataset) for p in range(passes)]
        out: dict[str, Any] = {}
        for name in runs[0]:
            v = np.array([r[name] for r in runs])
            out[name] = float(v.mean())
            out[f"{name}_std"] = float(v.std())
        out["passes"] = passes
        if log_path is not None:
            with open(log_path, "w") as f:
                for name, v in out.items():
                    f.write(f"{name}: {v}\n")
        return out

    # ----------------------------------------------------------- profiling

    @torch.inference_mode()
    def compare(self, x: Any, reference_probs: Any, seed: int = 0) -> dict:
        """The final exit's predictive against golden probabilities (≙
        ``HlsLayer.compare``, ``engine.py:305-316``): ``max_abs_diff``,
        ``mean_abs_diff`` and ``top1_agreement``."""
        p = self.predict(x, seed).probs[-1]
        ref = torch.as_tensor(reference_probs, dtype=p.dtype,
                              device=self.device)
        diff = (p - ref).abs()
        agree = (p.argmax(-1) == ref.argmax(-1)).float().mean()
        vals = torch.stack([diff.max(), diff.mean(), agree]).tolist()
        return dict(zip(("max_abs_diff", "mean_abs_diff", "top1_agreement"),
                        vals))

    @torch.inference_mode()
    def cost_analysis(self, sample_input: Any,
                      num_samples: int | None = None) -> dict:
        """What one predict of the engine's mapping costs, in the keys of
        the JAX engine's XLA report (``engine.py:318-337``), measured
        rather than modelled: ``argument_size_in_bytes`` (the model's
        parameters and buffers, the input and the seeds),
        ``output_size_in_bytes`` (the predictive), ``temp_size_in_bytes``
        (the peak one eager predict allocates, less its outputs:
        ``max_memory_allocated`` on a card, the live bytes of its ATen ops
        on the CPU, ``utils.profiler.temp_bytes``), and on a card
        ``device_ms`` and ``launches`` (every CUDA kernel of
        PROFILED_PREDICTS eager predicts under ``torch.profiler``, per
        predict; the profiler may miss the first launches of its window,
        so both can read a little low; None on the CPU). ``flops`` counts
        one predict's operations as ``utils.profiler.cost_report`` does
        (the ATen ops PyTorch's flop counter sees plus the port's kernels'
        recorded work); ``bytes_accessed`` is the arguments read once and
        the outputs written once (a roofline's model, not a measurement);
        ``generated_code_size_in_bytes`` is None: nothing is generated."""
        from torch.profiler import ProfilerActivity, profile

        from bayestpu_torch.utils.profiler import (counted_call, nbytes,
                                                   temp_bytes)

        s = sampler.num_effective_samples(self.bayes, num_samples)
        x = self._input(sample_input)
        seeds = self.seeds(0, s)
        fn = self._predict_fn()

        out, flops = counted_call(fn, x, seeds)
        arg_b = nbytes([*self.model.parameters(), *self.model.buffers(), x,
                        seeds])
        out_b = nbytes(out[:3])
        del out
        res: dict[str, Any] = {
            "flops": flops, "bytes_accessed": arg_b + out_b,
            "generated_code_size_in_bytes": None,
            "argument_size_in_bytes": arg_b,
            "output_size_in_bytes": out_b,
            "temp_size_in_bytes": temp_bytes(fn, x, seeds) - out_b,
            "device_ms": None, "launches": None}
        if self.device.type != "cuda":
            return res
        dev = self.device
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_PREDICTS):
                fn(x, seeds)
            torch.cuda.synchronize(dev)
        evs = device_events(prof)
        res["device_ms"] = sum(e.self_device_time_total
                               for e in evs) / PROFILED_PREDICTS / 1e3
        res["launches"] = sum(e.count for e in evs) / PROFILED_PREDICTS
        return res

    @torch.inference_mode()
    def benchmark(self, x: Any, iters: int = 20,
                  num_samples: int | None = None, min_diff_s: float = 0.3,
                  max_iters: int = 25600) -> dict:
        """Latency and throughput of ``predict`` as served: the compiled
        (graph-replayed) predict when this shape and S were compiled, else
        the eager one (``engine.py:339-362``). Windows of back-to-back
        predicts, timed by CUDA events on a card and by the host clock on
        the CPU (``utils.timing.measure_windows``); ``latency_s`` is the
        median window's per-call time. ``rtt_fallback`` is kept for the
        JAX keys and is always False: it flags the JAX package's
        round-trip-inclusive estimate on a remote TPU, which event-timed
        windows do not have."""
        from bayestpu_torch.utils.timing import measure_windows

        s = sampler.num_effective_samples(self.bayes, num_samples)
        x = self._input(x)
        res = measure_windows(lambda: self.predict(x, 0, s), self.device,
                              iters=iters, min_diff_s=min_diff_s,
                              max_iters=max_iters)
        dt = res.median_s
        b = x.shape[0]
        return {"latency_s": dt, "samples_per_s": b * s / dt,
                "images_per_s": b / dt, "num_samples": s,
                "rtt_fallback": False}


def _has_device_spans(model: torch.nn.Module) -> bool:
    """Whether the model's predict holds device-timed spans: those of its
    quantization (``quant.*``), in any layer with a ``QuantConfig``, and
    those of a model that says it has some (``device_spans``: the ResNets'
    ``resnet.stem``, ``sites.conv`` and ``sites.window_conv``)."""
    return any(getattr(m, "quant", None) is not None
               or getattr(m, "device_spans", False)
               for m in model.modules())


class _Graph:
    """A predict captured in a CUDA graph, with its static input, seed and
    output buffers. A ``timed`` predict holds device-timed spans: while
    spans record, ``predict`` replays its ``instrumented`` twin, captured
    at the first such replay with the spans' events as graph nodes
    (``utils.profiler.graph_spans``); otherwise this graph, which has
    none."""

    def __init__(self, graph, x: torch.Tensor, seeds: torch.Tensor,
                 out: Predictive, fn=None, timed: bool = False, spans=None):
        self.graph, self.x, self.seeds, self.out = graph, x, seeds, out
        self.fn, self.timed, self.spans = fn, timed, spans
        self._twin: _Graph | None = None

    @classmethod
    def capture(cls, fn, x: torch.Tensor, seeds: torch.Tensor,
                timed: bool = False, spans=None) -> "_Graph":
        """``fn(x, seeds)`` run twice on a side stream, then captured on
        copies of x and seeds, with Python's cyclic collector off: an
        engine and its graphs form a cycle (``fn`` holds the engine), so a
        collection inside the capture could destroy an earlier engine's
        graph, which is not permitted while a stream captures and fails
        this capture."""
        x, seeds = x.clone(), seeds.clone()
        cur = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(x, seeds)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = fn(x, seeds)
        finally:
            if collecting:
                gc.enable()
        return cls(graph, x, seeds, out, fn, timed, spans)

    def instrumented(self) -> "_Graph":
        """The twin whose device spans are graph nodes."""
        if self._twin is None:
            with graph_spans() as spans:
                self._twin = _Graph.capture(self.fn, self.x, self.seeds,
                                            spans=spans)
        return self._twin

    def replay(self, x: torch.Tensor, seeds: torch.Tensor,
               root=NO_SPAN) -> Predictive:
        """Copy x and the (host) seeds into the buffers, replay, and copy
        the outputs out before the next replay overwrites them. ``root``'s
        device clock stops just before the launch."""
        with span("engine.launch") as launch:
            self.x.copy_(x)
            self.seeds.copy_(seeds)
            root.stop_clock()
            self.graph.replay()
        if self.spans is not None:
            self.spans.replayed(launch)
        with span("engine.outputs"):
            return Predictive(self.out.probs.clone(), self.out.var.clone(),
                              self.out.entropy.clone(), self.out.num_samples)
