"""Training steps back to back, as the program's epoch loop runs them: the
MC seeds of a round of steps made on the host and copied in at once
(``make_train_epoch``'s feed), each step enqueued with no read-back; the
window ends when the card has finished the last step.

Traffic parameters: ``batch``, the optimizer chain (``clip``, ``lr``,
``momentum``, ``decay_steps`` of the cosine schedule), ``pool`` (distinct
batches of images and labels made on the device from the seed; a round
is one step on each, in turn), ``checked_steps`` (the run's first steps,
which the reference follows; the rest of the first round warms up) and
``traced_rounds``.

The program is trained as its users train it: ``make_train_step`` of the
model and the chain ``clip_by_global_norm → sgd(cosine, momentum)``, one
``TrainState`` from set-up to the window's end, seeds
``step_seeds(seed, steps, num_sites)``. The checked steps go through the
window's own call and feed; their losses, the momentum after the first
(the clipped first gradient) and each parameter's change after the last
are kept for the check.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from perfbench import trace, weights
from perfbench.drivers.predict_closed import build_model, params_of
from perfbench.reference import training
from perfbench.reference.common import Numerics, f32_mode

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone and is left out of the change
NOUGHT_GRAD = 1e-3


def _momentum(opt_state, names):
    """The dict of the optimizer's state keyed by the parameters' names
    (the momentum of ``trace``)."""
    if isinstance(opt_state, dict) and set(opt_state) == set(names):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _momentum(s, names)
            if found is not None:
                return found
    return None


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def setup(cell, seed: int, device) -> SimpleNamespace:
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import TrainState, make_train_step

    t, c = cell.traffic, cell.config
    model = build_model(cell).to(device)
    model.load_state_dict(params_of(cell, seed, device), strict=True)
    model.train()
    tx = optim.chain(optim.clip_by_global_norm(t["clip"]), optim.sgd(
        optim.cosine_decay_schedule(t["lr"], t["decay_steps"]),
        t["momentum"]))
    state = TrainState(model, tx.init(dict(model.named_parameters())))
    st = SimpleNamespace(
        cell=cell, seed=seed, device=device, state=state,
        step=make_train_step(model, tx), step_seeds=step_seeds,
        xs=weights.make_images(seed, t["pool"], t["batch"],
                               c["input_shape"], device),
        ys=weights.make_labels(seed, t["pool"], t["batch"],
                               c["num_classes"], device))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    kept = {"losses": []}

    def checked(i, metrics):
        if i < t["checked_steps"]:
            kept["losses"].append(float(metrics["loss"]))
        if i == 0:
            mom = _momentum(state.opt_state, list(p0))
            kept["first"] = _norms(mom)
            kept["first_vec"] = {k: v.detach().float().cpu()
                                 for k, v in mom.items()}
        if i == t["checked_steps"] - 1:
            kept["change"] = _norms({k: v.detach() - p0[k]
                                     for k, v in model.named_parameters()})

    _round(st, trace.no_span, checked)
    _sync(st, trace.no_span)
    st.kept = kept
    return st


def _round(st, span, after=None, unit=False, last_sync=False) -> int:
    """One round: the seeds of its steps computed and copied at once, then
    a step on each batch of the pool. ``after(step, metrics)`` sees each
    step; with ``unit`` each step is a traced unit, the last one ending in
    a synchronize when ``last_sync``."""
    n = st.xs.shape[0]
    step0 = st.state.step
    for j in range(n):
        with span(trace.UNIT) if unit else trace.no_span(trace.UNIT):
            if j == 0:
                with span("seeds"):
                    seeds = st.step_seeds(st.seed, range(step0, step0 + n),
                                          st.state.model.num_sites).to(
                                              st.device)
            with span("step"):
                m = st.step(st.state, st.xs[j], st.ys[j], seeds[j])
            if after is not None:
                after(step0 + j, m)
            if last_sync and j == n - 1:
                _sync(st, span)
    return n


def _sync(st, span) -> None:
    if st.device.type == "cuda":
        with span("sync"):
            torch.cuda.synchronize(st.device)


def window(st, seconds: float, traced: bool) -> SimpleNamespace:
    t_start = time.perf_counter()
    t_end = t_start + seconds
    steps = 0
    while time.perf_counter() < t_end:
        steps += _round(st, trace.no_span)
    _sync(st, trace.no_span)
    window_s = time.perf_counter() - t_start
    rec = SimpleNamespace(kind="train", window_s=window_s, attempted=steps,
                          failed=0, steps=steps,
                          batch=st.cell.traffic["batch"], trace=None)
    if traced:
        rounds = st.cell.traffic["traced_rounds"]

        def tail():
            _round(st, trace.span)      # the profiler's first launches are
            _sync(st, trace.span)       # often lost
            for r in range(rounds):
                _round(st, trace.span, unit=True,
                       last_sync=r == rounds - 1)

        rec.trace = trace.profiled(tail)
    return rec


def release(st) -> None:
    st.state = st.step = None
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        torch.cuda.empty_cache()


def reference_steps(st, num: Numerics = Numerics(), rows: int | None = None,
                    frozen: bool = False) -> dict:
    cell = st.cell
    f32_mode()
    params = params_of(cell, st.seed, st.device)
    t = cell.traffic
    out = training.follow(cell.reference, cell.config, params, st.xs, st.ys,
                          st.seed, t["checked_steps"], t, num, rows, frozen)
    return {"losses": out["losses"], "first": _norms(out["first"]),
            "first_vec": {k: v.float().cpu()
                          for k, v in out["first"].items()},
            "change": _norms(out["change"])}


def _leaf_gap(got: dict, ref: dict, keys) -> float:
    """The worst leaf's gap of norms, against the larger of its reference
    norm and the median leaf's."""
    vals = sorted(ref[k] for k in keys)
    median = vals[len(vals) // 2]
    return max(abs(got[k] - ref[k]) / max(ref[k], median) for k in keys)


def _cos_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """1 − cos of two gradients' directions (1 where one is zero)."""
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return 1.0 - (float(a @ b) / den if den > 0 else 0.0)


def gaps(got: dict, ref: dict) -> dict:
    """loss_gap: the widest relative gap of a checked step's loss;
    grad_gap and change_gap: the worst leaf's gap of norms of the first
    gradient and of the change; grad_dir_gap: the worst leaf's 1 − cos
    between the program's first gradient and the reference's. Leaves
    whose reference gradient is nought to rounding are left out of the
    change and of the direction."""
    first = ref["first"]
    med = sorted(first.values())[len(first) // 2]
    moving = [k for k in first if first[k] >= NOUGHT_GRAD * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_gap": _leaf_gap(got["first"], first, list(first)),
            "change_gap": _leaf_gap(got["change"], ref["change"], moving),
            "grad_dir_gap": max(_cos_gap(got["first_vec"][k],
                                         ref["first_vec"][k])
                                for k in moving)}


CONTROLS = {
    "control": lambda st: reference_steps(st, Numerics("fp8")),
    "half_batch": lambda st: reference_steps(
        st, rows=st.cell.traffic["batch"] // 2),
    "unchanged": lambda st: reference_steps(st, frozen=True),
}


def check(st, record, control: str | None = None) -> dict:
    """The program's first steps against the reference's; ``control``
    puts in the program's place the reference in fp8 ("control"), on the
    first half of each batch ("half_batch") or with its state left
    unchanged ("unchanged")."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"no control {control!r} for a training cell")
    ref = reference_steps(st)
    got = st.kept if control is None else CONTROLS[control](st)
    return gaps(got, ref)
