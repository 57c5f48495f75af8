"""The port's sample-axis and data-parallel sharding (``engine.sharding``,
``engine.distributed``, ``train_loop(mesh=...)``) in a real 4-rank gloo
world on the CPU, against the JAX package's.

One world per module: the fixture ``world`` builds the references with the
JAX package on 4 of the 8 virtual CPU devices of ``tests/conftest.py``
(the seeds every MC site draws are captured from JAX, so both packages
draw the same masks), writes the inputs, then starts this file as a
script in 4 processes (``python test_torch_port_sharding.py RANK DIR``).
The workers import torch and the port only, meet through a ``file://``
rendezvous in the fixture's directory, run every case on the meshes (1, 4),
(2, 2) and (4, 1) and write their results; each test asserts one case.
Every wait on a worker has a time limit and fails the module when it
passes, so a hung rendezvous fails here instead of stalling the run.

Tolerances: f32 probabilities 1e-5 (JAX's sharded predictive sums in its
own order); bf16 0.02 (the bf16 model tolerance of the other port tests);
the port's sharded mean and variance against its own local predictive
1e-6 (summation order only), and each sample's logits bit-equal to the
local predict's on a sample-only mesh; a data-parallel f32 step within
3e-4 of each gradient's norm of JAX's step on the whole batch and 1e-5 of
the port's one-process step.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WORLD = 4
MESHES = [(1, 4), (2, 2), (4, 1)]
TIMEOUT_S = 120
REPO = Path(__file__).resolve().parents[1]
RATE = 0.3
MASK = dict(kind="mask", num_masks=4, scale=2.0)


# ------------------------------------------------- the workers (torch only)


def _port_model(spec):
    """A port model from (zoo name, keyword dict) with its variables."""
    from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                            QuantConfig)
    from bayestpu_torch.interop.from_flax import load_flax_variables
    from bayestpu_torch.nn.zoo import get_model
    name, kw, variables = spec
    kw = dict(kw)
    b = dict(kw.pop("bayes"))
    if b.get("kind") == "mask":
        b["kind"] = DropoutKind.MASK
    kw["bayes"] = BayesConfig(**b)
    kw["dtype"] = {"f32": torch.float32,
                   "bf16": torch.bfloat16}[kw.pop("dtype", "f32")]
    if kw.pop("int8", False):
        kw["quant"] = QuantConfig(8, 0, int8_infer=True)
    return load_flax_variables(get_model(name, **kw), variables)


def _predict_cases(ref, meshes, out):
    """Every sharded predictive case on every mesh it names: the moments,
    and the largest difference of this rank's per-sample logits from the
    same samples and rows of the one-process spatial predict."""
    from bayestpu_torch.engine import sharding
    for name, case in ref["predict"].items():
        model = _port_model(case["model"])
        x = torch.from_numpy(case["x"])
        seeds = torch.from_numpy(case["seeds"])
        with torch.inference_mode():
            local = model(x, seeds).logits.float()
            lp = torch.softmax(local, dim=-1)
            out[name, "local"] = (lp.mean(0).numpy(),
                                  lp.var(0, correction=0).numpy())
            for m in case["meshes"]:
                mesh = meshes[m]
                p = sharding.sharded_predictive(model, x, seeds, mesh)
                blk, a, row0 = sharding.shard_logits(model, x, seeds, mesh)
                ref_blk = local[a:a + blk.shape[0], :,
                                row0:row0 + blk.shape[-2]]
                out[name, m] = dict(
                    probs=p.probs.numpy(), var=p.var.numpy(),
                    n=p.num_samples,
                    diff=float((blk.float() - ref_blk).abs().max()))


def _padding_case(ref, meshes, out):
    """S = 6 on a sample axis of 4: the engine pads to 8; its samples 0-5
    are the unpadded ones."""
    from bayestpu_torch.core.rng import sample_seeds
    from bayestpu_torch.engine import sharding
    from bayestpu_torch.engine.engine import BayesEngine
    case = ref["padding"]
    model = _port_model(case["model"])
    mesh = meshes[(1, 4)]
    x = torch.from_numpy(case["x"])
    seeds8 = torch.from_numpy(case["seeds"])
    with torch.inference_mode():
        got = sharding.sharded_predictive(model, x, seeds8, mesh)
        blk, a, _ = sharding.shard_logits(model, x, seeds8, mesh)
        unpadded = model(x, seeds8[:6]).logits.float()
        keep = max(min(6 - a, blk.shape[0]), 0)
        eng = BayesEngine(model, device="cpu", mesh=mesh)
        eng.ready = True
        served = eng.predict(x, seed=3, num_samples=6)
        direct = sharding.sharded_predictive(
            model, x, sample_seeds(3, 8, model.num_sites), mesh)
    out["padding"] = dict(
        probs=got.probs.numpy(), n=got.num_samples, served_n=
        served.num_samples, served_equal=bool(
            torch.equal(served.probs, direct.probs)
            and torch.equal(served.var, direct.var)),
        prefix=bool(torch.equal(sample_seeds(3, 8, model.num_sites)[:6],
                                sample_seeds(3, 6, model.num_sites))),
        diff=float((blk[:keep].float() - unpadded[a:a + keep]).abs().max())
        if keep else 0.0)


def _evaluate_cases(ref, meshes, out):
    from bayestpu_torch.engine import distributed
    case = ref["evaluate"]
    model = _port_model(case["model"])
    for m in MESHES:
        out["evaluate", m] = distributed.distributed_evaluate(
            model, case["x"], case["y"], case["seeds"].shape[0], meshes[m],
            seeds=torch.from_numpy(case["seeds"]))


def _grads_of_step(case, mesh):
    """One step of ``make_train_step`` (with ``mesh``, or on one process):
    its loss, the gradients it hands the optimizer (by name, conv kernels
    HWIO), and the BatchNorm statistics after it."""
    from bayestpu_torch.interop.from_flax import to_flax_variables
    from bayestpu_torch.train.loop import TrainState, make_train_step
    from bayestpu_torch.train.optim import GradientTransformation
    model = _port_model(case["model"]).train()
    seen = {}

    def update(updates, state, params=None):
        seen.update({k: v.detach().clone() for k, v in updates.items()})
        return {k: torch.zeros_like(v) for k, v in updates.items()}, state

    tx = GradientTransformation(lambda params: (), update)
    step = make_train_step(model, tx, mesh=mesh)
    m = step(TrainState(model, ()), torch.from_numpy(case["x"]),
             torch.from_numpy(case["y"]).long(),
             torch.from_numpy(case["seeds"]))
    grads = {k: (g.numpy().transpose(2, 3, 1, 0) if g.dim() == 4
                 else g.numpy()) for k, g in seen.items()}
    stats = to_flax_variables(model).get("batch_stats", {})
    return dict(loss=float(m["loss"]), grads=grads, stats=_flat(stats),
                top1=float(m[max(k for k in m if k.endswith("_top1")
                                 and k.startswith("exit"))]))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _step_cases(ref, meshes, out):
    for name, case in ref["step"].items():
        out[name, None] = _grads_of_step(case, None)
        for m in case["meshes"]:
            out[name, m] = _grads_of_step(case, meshes[m])


def _train_loop_case(ref, meshes, out):
    """3 epochs of ``train_loop(mesh=(4, 1))`` on lenet_me: the logged
    losses (the first rank's log only) and this rank's parameters."""
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.train.loop import create_state, train_loop
    from bayestpu_torch.train.optim import get_optimizer, get_recipe
    case = ref["loop"]
    model = get_model("lenet_me", bayes=BayesConfig(rate=0.25), fused=True)
    tx = get_optimizer(get_recipe("lenet"))
    # a rank-dependent init: train_loop broadcasts the first rank's state
    state = create_state(model, tx, 1 + (0 if torch.distributed.get_rank()
                                         == 0 else 7),
                         case["x"][0], device="cpu")
    logs, history = [], {}
    train_loop(model, state, tx, lambda: list(zip(case["x"], case["y"])),
               5, 3, mesh=meshes[(4, 1)], reshuffle=True, history=history,
               log_fn=logs.append)
    out["loop"] = dict(logs=logs, losses=history["train_loss"],
                       params={k: p.detach().numpy().copy()
                               for k, p in model.named_parameters()})


def _put(workdir, name: str, obj) -> None:
    """Write ``obj`` to ``workdir/name.pkl`` whole (a rename), so that a
    reader never sees half of it."""
    path = os.path.join(workdir, name + ".pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def _get(workdir, name: str, deadline: float):
    """Wait for ``workdir/name.pkl`` until ``deadline`` (raises then)."""
    path = os.path.join(workdir, name + ".pkl")
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def _worker(rank: int, workdir: str) -> None:
    """One rank: it starts (imports, rendezvous, meshes) while the JAX
    references are made, then runs the predictive cases as soon as their
    inputs are written and the training cases when theirs are."""
    deadline = time.monotonic() + TIMEOUT_S
    torch.set_num_threads(1)
    from bayestpu_torch.engine import distributed, sharding
    distributed.initialize(f"file://{workdir}/rendezvous", WORLD, rank,
                           "gloo")
    meshes = {m: sharding.make_mesh(*m) for m in MESHES}
    out: dict = {"pod_mesh": distributed.pod_mesh().shape}
    for m, mesh in meshes.items():
        rows = torch.arange(8)
        out["put_global", m] = {
            spec: distributed.put_global({"x": rows}, mesh, spec)[
                "x"].tolist() for spec in ("data", "sample", None)}
        out["shard_batch", m] = sharding.shard_batch((rows, -rows),
                                                     mesh)[1].tolist()
    ref = _get(workdir, "predict", deadline)
    _predict_cases(ref, meshes, out)
    _padding_case(ref, meshes, out)
    ref = _get(workdir, "train", deadline)
    _evaluate_cases(ref, meshes, out)
    _step_cases(ref, meshes, out)
    _train_loop_case(ref, meshes, out)
    _put(workdir, f"out{rank}", out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
    sys.exit(0)


# ------------------------------------------------ the JAX references

import pytest  # noqa: E402

from port_threads import thread_budget  # noqa: E402,F401


def _capture(jm, variables, x, key, num):
    """JAX's spatial per-sample logits (S, E, B, C) of ``num`` samples
    (``sample_keys(key, num)``, as ``sampler.mc_logits`` and
    ``sharded_predictive`` draw them), and the seed pair of every MC site in
    call order (S, n_sites, 2), both out of one jitted vmap: the threefry
    key of a materialized site (a wrapper of ``jax.random.bernoulli``) and
    the seeds a fused site passes its kernel (wrappers of the sites'
    kernel entries), as ``capture_site_keys`` records them eagerly."""
    import jax
    import jax.numpy as jnp
    import bayestpu.nn.fused as jfused
    from bayestpu.core.rng import sample_keys
    from test_torch_port_threefry import FUSED_SITES
    seen = []
    orig_b = jax.random.bernoulli
    origs = {n: getattr(jfused, n) for n in FUSED_SITES}

    def bern(k, p, shape):
        seen.append(jax.lax.bitcast_convert_type(jax.random.key_data(k),
                                                 jnp.int32))
        return orig_b(k, p, shape)

    def spy(name):
        def f(xx, w, seeds, *a, **kw):
            seen.append(jnp.asarray(seeds).astype(jnp.int32))
            return origs[name](xx, w, seeds, *a, **kw)
        return f

    def one(k, i):
        seen.clear()
        lg = jm.apply(variables, jnp.asarray(x), sample_idx=i, train=False,
                      rngs={"bayes": k}).logits
        return lg.astype(jnp.float32), (jnp.stack(seen) if seen else
                                        jnp.zeros((0, 2), jnp.int32))

    jax.random.bernoulli = bern
    for n in FUSED_SITES:
        setattr(jfused, n, spy(n))
    try:
        logits, seeds = jax.jit(jax.vmap(one))(
            sample_keys(key, num), jnp.arange(num, dtype=jnp.int32))
    finally:
        jax.random.bernoulli = orig_b
        for n, f in origs.items():
            setattr(jfused, n, f)
    return np.array(logits), np.array(seeds)


_VARIABLES: dict = {}


def _models(name, kw, seed=0):
    """The JAX model and the port's (name, keywords, variables) spec, on
    the variables of the port's init (Flax's initializers), biases moved
    off zero; one variables tree for every dtype of a model, so that a
    pickle holds it once."""
    import jax.numpy as jnp
    from bayestpu.core.config import (BayesConfig as JBayes,
                                      DropoutKind as JKind,
                                      QuantConfig as JQuant)
    from bayestpu.nn.zoo import get_model as jax_get_model
    from bayestpu_torch.core.config import BayesConfig, DropoutKind
    from bayestpu_torch.interop.from_flax import to_flax_variables
    from bayestpu_torch.nn.zoo import get_model
    b = dict(kw["bayes"])
    tb = dict(b)
    if b.get("kind") == "mask":
        b["kind"], tb["kind"] = JKind.MASK, DropoutKind.MASK
    extra = {k: v for k, v in kw.items()
             if k not in ("bayes", "dtype", "int8")}
    cache = (name, repr(sorted(extra.items())), repr(tb), seed)
    if cache not in _VARIABLES:
        port = get_model(name, bayes=BayesConfig(**tb), **extra)
        port.reset_parameters(torch.Generator().manual_seed(seed))
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for k, p in port.named_parameters():
                if k.endswith("bias"):
                    p.add_(torch.from_numpy(rng.normal(
                        scale=0.1, size=p.shape).astype(np.float32)))
        _VARIABLES[cache] = to_flax_variables(port)
    variables = _VARIABLES[cache]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[kw.get("dtype", "f32")]
    jq = JQuant(8, 0, int8_infer=True) if kw.get("int8") else None
    jm = jax_get_model(name, bayes=JBayes(**b), dtype=jdt, quant=jq, **extra)
    return jm, variables, (name, kw, variables)


def _jax_mesh(m):
    import jax
    from bayestpu.engine import sharding as jsharding
    return jsharding.make_mesh(*m, devices=jax.devices()[:WORLD])


def _moments(logits):
    """The JAX sampler's mean and variance of per-sample logits."""
    import jax
    import jax.numpy as jnp
    p = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    return np.asarray(jnp.mean(p, axis=0)), np.asarray(jnp.var(p, axis=0))


def _jax_step(jm, variables, x, y, key):
    """JAX's training step on the whole batch: the EED loss and its
    gradients (the jitted ``value_and_grad``, BatchNorm on batch
    statistics), the updated statistics, and the seeds its fused heads
    drew, traced out of the same jit (a wrapper of ``dropout_matmul``)."""
    import jax
    import jax.numpy as jnp
    import bayestpu.nn.fused as jfused
    from bayestpu.train.losses import eed_loss as jax_eed_loss
    seen, orig = [], jfused.dropout_matmul

    def spy(xx, w, seeds, r, **kw):
        seen.append(jnp.asarray(seeds).astype(jnp.int32))
        return orig(xx, w, seeds, r, **kw)

    def loss_fn(params):
        seen.clear()
        rest = {k: v for k, v in variables.items() if k != "params"}
        o, upd = jm.apply({"params": params, **rest}, jnp.asarray(x),
                          train=True, rngs={"bayes": key},
                          mutable=["batch_stats"])
        seeds = (jnp.stack(seen) if seen else jnp.zeros((0, 2), jnp.int32))
        return (jax_eed_loss(o.logits, jnp.asarray(y), o.features),
                (upd, seeds))

    jfused.dropout_matmul = spy
    try:
        (loss, (upd, seeds)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    finally:
        jfused.dropout_matmul = orig
    return dict(loss=float(loss), grads=_flat(jax.tree.map(np.asarray,
                                                           grads)),
                stats=_flat(jax.tree.map(np.asarray,
                                         upd.get("batch_stats", {})))), \
        np.array(seeds)


def _f64_step(spec, x, y, seeds):
    """The gradients of the port's one-process step with the model in
    float64 (the fused heads, which take f32 or bf16, in f32): the exact
    step to within ~1e-6, against which JAX's own f32 rounding shows."""
    from bayestpu_torch.train.losses import eed_loss
    model = _port_model(spec).double().train()
    params = dict(model.named_parameters())
    out = model(torch.from_numpy(x).double(), torch.from_numpy(seeds))
    loss = eed_loss(out.logits, torch.from_numpy(y).long(), out.features)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {k: (g.numpy().transpose(2, 3, 1, 0) if g.dim() == 4
                else g.numpy()) for k, g in zip(params, grads)}


def _start_world(work: Path) -> list:
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, __file__, str(r), str(work)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def _join_world(procs: list, work: Path, deadline: float) -> list:
    """Every rank's results; a rank that fails, or a world that is not done
    by ``deadline``, fails the module (the processes are killed)."""
    logs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the {WORLD}-rank world did not finish in {TIMEOUT_S} "
                    "s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [_get(work, f"out{r}", deadline) for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world, started first, the JAX references made while it
    starts and runs, and its results: (want, outs), outs[r] the results of
    rank r."""
    work = tmp_path_factory.mktemp("sharding_world")
    deadline = time.monotonic() + TIMEOUT_S
    procs = _start_world(work)
    try:
        want = _references(work)
    except BaseException:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise
    return want, _join_world(procs, work, deadline)


def _references(work: Path) -> dict:
    """The inputs and captured seeds, written for the workers as soon as
    each part is ready, and the JAX references the tests hold them to."""
    import jax
    from bayestpu.engine import distributed as jdist
    from bayestpu.engine import sharding as jsharding

    rng = np.random.default_rng(0)
    key = jax.random.key(5)
    ref = {"predict": {}}
    want = {}
    jax_models = {}
    mnist = rng.normal(size=(8, 28, 28, 1)).astype(np.float32)
    cifar = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)

    # (a) lenet with three threefry sites, (b) fused lenet, MC and
    # Masksembles (tests/test_distributed.py's), (c) a narrow vgg11_me in
    # f32, bf16 and int8, (d) the block-site vgg11
    cases = {
        "lenet_threefry": ("lenet", dict(bayes=dict(rate=RATE,
                                                    num_bayes_layers=3)),
                           mnist, 8),
        "lenet_fused_mc": ("lenet", dict(bayes=dict(rate=RATE), fused=True),
                           mnist, 8),
        "lenet_fused_mask": ("lenet", dict(bayes=MASK, fused=True), mnist,
                             8),
        "vgg11_me_f32": ("vgg11_me", dict(bayes=dict(rate=0.25), fused=True,
                                          head_dims=(64, 64)), cifar, 4),
        "vgg11_me_bf16": ("vgg11_me", dict(bayes=dict(rate=0.25), fused=True,
                                           head_dims=(64, 64), dtype="bf16"),
                          cifar, 4),
        "vgg11_me_int8": ("vgg11_me", dict(bayes=dict(rate=0.25), fused=True,
                                           head_dims=(64, 64), int8=True),
                          cifar, 4),
        "vgg11_block": ("vgg11", dict(bayes=dict(rate=0.25), fused=True,
                                      dropout="block", head_dims=(64, 64)),
                        cifar, 4),
    }
    for name, (zoo, kw, x, num) in cases.items():
        jm, vs, spec = _models(zoo, kw)
        jax_models[name] = (jm, vs)
        logits, seeds = _capture(jm, vs, x, key, num)
        ref["predict"][name] = dict(model=spec, x=x, seeds=seeds,
                                    meshes=MESHES)
        want[name, "local"] = _moments(logits)
    # (e) padding: S = 6 on the sample axis of 4 runs the first 8 samples
    ref["padding"] = dict(ref["predict"]["lenet_threefry"])
    _put(work, "predict", ref)
    ref = {"step": {}}

    # (f) distributed_evaluate (tests/test_multiprocess.py's lenet)
    jm, vs, spec = _models("lenet", dict(bayes=dict(rate=RATE)))
    jax_models["evaluate"] = (jm, vs)
    y = rng.integers(0, 10, size=8).astype(np.int32)
    _, seeds = _capture(jm, vs, mnist, key, 8)
    ref["evaluate"] = dict(model=spec, x=mnist, y=y, seeds=seeds)

    # (g) an f32 data-parallel vgg11_me step; (i) a Masksembles one
    xb = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    yb = np.array([0, 3, 7, 3, 1, 9, 9, 2], np.int32)
    jm, vs, step_spec = _models("vgg11_me", dict(
        bayes=dict(rate=0.25), fused=True, head_dims=(64, 64)))
    want["vgg11_me_step"], step_seeds = _jax_step(jm, vs, xb, yb,
                                                  jax.random.key(9))
    ref["step"]["vgg11_me_step"] = dict(model=step_spec, x=xb, y=yb,
                                        seeds=step_seeds,
                                        meshes=[(4, 1), (2, 2)])
    _, _, spec = _models("lenet_me", dict(bayes=MASK, fused=True))
    ref["step"]["mask_step"] = dict(
        model=spec, x=mnist, y=y, seeds=np.zeros((0, 2), np.int32),
        meshes=[(2, 2)])

    # (h) train_loop: 3 batches of 16
    ref["loop"] = dict(
        x=rng.normal(size=(3, 16, 28, 28, 1)).astype(np.float32),
        y=(np.arange(48) % 10).astype(np.int32).reshape(3, 16))

    _put(work, "train", ref)
    # the references the workers do not need, while they run
    jm, vs = jax_models["lenet_threefry"]
    for m in MESHES:
        p = jsharding.sharded_predictive(jm, vs, mnist, key, 8,
                                         _jax_mesh(m))
        want["lenet_threefry", m] = (np.asarray(p.probs),
                                     np.asarray(p.var))
    p = jsharding.sharded_predictive(jm, vs, mnist, key, 6,
                                     _jax_mesh((1, 4)))
    want["padding"] = (np.asarray(p.probs), p.num_samples)
    for name in ("lenet_fused_mc", "lenet_fused_mask", "vgg11_me_f32"):
        jm, vs = jax_models[name]
        _, _, x, num = cases[name]
        p = jsharding.sharded_predictive(jm, vs, x, key, num,
                                         _jax_mesh((2, 2)))
        want[name, "sharded"] = (np.asarray(p.probs), np.asarray(p.var))
    jm, vs = jax_models["evaluate"]
    want["evaluate"] = jdist.distributed_evaluate(
        jm, vs, mnist, y, 8, _jax_mesh((2, 2)), key)
    want["vgg11_me_step_f64"] = _f64_step(step_spec, xb, yb, step_seeds)
    return want


# ----------------------------------------------------------- the cases


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _same_on_every_rank(outs, key):
    for r in range(1, WORLD):
        for k in ("probs", "var"):
            np.testing.assert_array_equal(outs[r][key][k], outs[0][key][k])


@pytest.mark.parametrize("mesh", MESHES)
def test_threefry_lenet_matches_jax_sharded_predictive(world, mesh):
    """(a) lenet with three threefry sites at rate 0.3, S = 8, batch 8:
    equal to JAX's ``sharded_predictive`` on the same mesh (f32, 1e-5), to
    the port's local predictive (1e-6); each sample's logits bit-equal to
    the local predict's on the sample-only mesh, and within 1e-5 where the
    data axis splits the batch (the masks are keyed on the global rows)."""
    want, outs = world
    got = outs[0]["lenet_threefry", mesh]
    assert got["n"] == 8
    _close(got["probs"], want["lenet_threefry", mesh][0], 1e-5)
    _close(got["var"], want["lenet_threefry", mesh][1], 1e-5)
    local = outs[0]["lenet_threefry", "local"]
    _close(got["probs"], local[0], 1e-6)
    _close(got["var"], local[1], 1e-6)
    _same_on_every_rank(outs, ("lenet_threefry", mesh))
    for r in range(WORLD):
        diff = outs[r]["lenet_threefry", mesh]["diff"]
        assert diff == 0.0 if mesh[0] == 1 else diff <= 1e-5, (r, diff)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case,tol", [
    ("lenet_fused_mc", 1e-5), ("lenet_fused_mask", 1e-5),
    ("vgg11_me_f32", 1e-5), ("vgg11_me_bf16", 0.02),
    ("vgg11_me_int8", 1e-5), ("vgg11_block", 1e-5)])
def test_sharded_predictive_matches_jax(world, case, tol, mesh):
    """(b)-(d) fused lenet (MC, row 3; Masksembles, row 8), a narrow
    vgg11_me (MC heads: row 3 in f32 and bf16, row 5 in int8) and the
    block-site vgg11 (row 10 with the sample axis carried): against JAX's
    spatial predictive on the same seeds (and its ``sharded_predictive`` on
    the (2, 2) mesh where taken), to the port's local predictive 1e-6, each
    sample's logits bit-equal to the local predict's on the sample-only
    mesh and within the model's tolerance where the data axis splits the
    batch."""
    want, outs = world
    got = outs[0][case, mesh]
    _close(got["probs"], want[case, "local"][0], tol)
    _close(got["var"], want[case, "local"][1], tol)
    if (case, "sharded") in want:
        _close(got["probs"], want[case, "sharded"][0], tol)
    local = outs[0][case, "local"]
    _close(got["probs"], local[0], 1e-6)
    _close(got["var"], local[1], 1e-6)
    _same_on_every_rank(outs, (case, mesh))
    for r in range(WORLD):
        diff = outs[r][case, mesh]["diff"]
        assert diff == 0.0 if mesh[0] == 1 else diff <= tol, (r, diff)


def test_padding_follows_jax(world):
    """(e) S = 6 on a sample axis of 4 runs 8 samples, as JAX pads; the
    moments equal JAX's padded ones, samples 0-5 equal the unpadded run's
    bit for bit, and the engine pads its own seeds the same way."""
    want, outs = world
    got = outs[0]["padding"]
    assert got["n"] == want["padding"][1] == 8
    _close(got["probs"], want["padding"][0], 1e-5)
    for r in range(WORLD):
        assert outs[r]["padding"]["diff"] == 0.0
        assert outs[r]["padding"]["served_n"] == 8
        assert outs[r]["padding"]["served_equal"]
        assert outs[r]["padding"]["prefix"]


@pytest.mark.parametrize("mesh", MESHES)
def test_distributed_evaluate_matches_jax(world, mesh):
    """(f) ``distributed_evaluate`` on lenet at rate 0.3, S = 8, batch 8:
    acc and n equal JAX's, nll within rtol 1e-5, ece within 1e-6; the same
    on every rank."""
    want, outs = world
    got = outs[0]["evaluate", mesh]
    assert got["acc"] == pytest.approx(want["evaluate"]["acc"], abs=1e-7)
    assert got["n"] == want["evaluate"]["n"] == 8
    assert got["nll"] == pytest.approx(want["evaluate"]["nll"], rel=1e-5)
    assert got["ece"] == pytest.approx(want["evaluate"]["ece"], abs=1e-6)
    for r in range(1, WORLD):
        assert outs[r]["evaluate", mesh] == got


def _grads_close(got, want, rtol, noise=None):
    """Per tensor ``‖got − want‖ ≤ rtol·‖want‖ + 2·‖want − noise‖ +
    1e-5``: the bound of ``test_torch_port_train._close`` (a bias that
    feeds a BatchNorm has a gradient of rounding noise alone); ``noise``,
    where given, is the exact step, so that ``want`` is held to no more
    than its own distance from it."""
    assert set(got) == set(want)
    bad = []
    for k, g in got.items():
        err = np.linalg.norm(g - want[k])
        bound = rtol * np.linalg.norm(want[k]) + 1e-5
        if noise is not None:
            bound += 2 * np.linalg.norm(want[k] - noise[k])
        if err > bound:
            bad.append((float(err / (np.linalg.norm(want[k]) + 1e-30)), k))
    assert not bad, sorted(bad)[-3:]


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2)])
def test_data_parallel_step_matches_jax(world, mesh):
    """(g) one f32 step of a narrow vgg11_me (its BatchNorms on the global
    batch) at global batch 8: the loss within 1e-6 of JAX's step on the
    whole batch; each gradient within 3e-4 of its norm of the exact step
    (the port's in float64) and of JAX's, plus JAX's own distance from the
    exact step (Known differences: on this batch JAX's f32 gradients of
    the exit-2 head lie 2.4e-2 of their norm from it, the port's 1.3e-6);
    against the port's one-process step 1e-5 of each norm plus twice that
    step's own distance from the exact one (measured up to 2.4e-5 of a
    norm where the one-process step lies 1.5e-5 from the exact), the
    BatchNorm statistics 1e-5; every rank hands the optimizer the same
    gradients."""
    want, outs = world
    got = outs[0]["vgg11_me_step", mesh]
    one = outs[0]["vgg11_me_step", None]
    jw = want["vgg11_me_step"]
    assert got["loss"] == pytest.approx(jw["loss"], rel=1e-6)
    _grads_close(got["grads"], want["vgg11_me_step_f64"], 3e-4)
    _grads_close(got["grads"], jw["grads"], 3e-4,
                 want["vgg11_me_step_f64"])
    _grads_close(got["grads"], one["grads"], 1e-5,
                 {k: want["vgg11_me_step_f64"][k] for k in one["grads"]})
    _grads_close(got["stats"], one["stats"], 1e-5)
    _grads_close(got["stats"], jw["stats"], 1e-5)
    for r in range(1, WORLD):
        for k, g in outs[r]["vgg11_me_step", mesh]["grads"].items():
            np.testing.assert_array_equal(g, got["grads"][k])


def test_masksembles_step_matches_one_process(world):
    """(i) a Masksembles lenet_me step at d = 2, batch 8: the global batch
    split (group g of the global batch under mask g), so the gradients
    are the one-process step's within 1e-5 of each norm."""
    _, outs = world
    got = outs[0]["mask_step", (2, 2)]
    one = outs[0]["mask_step", None]
    assert got["loss"] == pytest.approx(one["loss"], rel=1e-6)
    _grads_close(got["grads"], one["grads"], 1e-5)


def test_train_loop_on_a_mesh(world):
    """(h) ``train_loop(mesh=(4, 1))`` on lenet_me, 3 epochs, reshuffled:
    the loss falls, only the first rank logs, every rank keeps the same
    history, and the parameters are bit-identical on every rank (each rank
    started from its own init; the first rank's was broadcast)."""
    _, outs = world
    loop = outs[0]["loop"]
    assert loop["losses"][-1] < loop["losses"][0]
    assert len(loop["logs"]) == 3
    for r in range(1, WORLD):
        assert outs[r]["loop"]["logs"] == []
        assert outs[r]["loop"]["losses"] == loop["losses"]
        for k, p in outs[r]["loop"]["params"].items():
            np.testing.assert_array_equal(p, loop["params"][k])


@pytest.mark.parametrize("mesh", MESHES)
def test_put_global_and_shard_batch_take_this_ranks_block(world, mesh):
    """``put_global`` gives rank (i, j) of a (d, s) mesh block i of d of
    the leading axis under ``"data"``, block j of s under ``"sample"`` and
    everything under None; ``shard_batch`` the data block of each member of
    a tuple; ``pod_mesh`` with no host size puts every rank on the sample
    axis."""
    _, outs = world
    d, s = mesh
    for r, out in enumerate(outs):
        i, j = r // s, r % s
        got = out["put_global", mesh]
        assert got["data"] == list(range(i * 8 // d, (i + 1) * 8 // d))
        assert got["sample"] == list(range(j * 8 // s, (j + 1) * 8 // s))
        assert got[None] == list(range(8))
        assert out["shard_batch", mesh] == [-v for v in got["data"]]
        assert out["pod_mesh"] == {"data": 1, "sample": WORLD}


def test_initialize_is_a_no_op_alone_and_never_falls_back(monkeypatch,
                                                         tmp_path):
    """Without arguments or ``RANK``/``WORLD_SIZE`` there is nothing to
    start; a backend that does not exist raises and nothing is started on
    another."""
    import torch.distributed as dist
    from bayestpu_torch.engine import distributed
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not dist.is_initialized()
    # torch refuses an unknown backend with an AssertionError
    with pytest.raises((AssertionError, ValueError, RuntimeError)):
        distributed.initialize(f"file://{tmp_path}/rendezvous", 1, 0,
                               "no_such_backend")
    assert not dist.is_initialized()
