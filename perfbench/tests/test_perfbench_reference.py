"""The plain references against the port on the CPU, at small batches and
the configurations' widths: in f32 they agree to rounding, so the masks,
the layouts, the grids and the training step are the same computation."""

import json

import torch

from conftest import ROOT
from perfbench import harness, weights
from perfbench.drivers import predict_closed, train_steps
from perfbench.reference import common

SEED = 2 ** 31 + 11


def cell_with(name, **config):
    cell = harness.load_cell(ROOT, name)
    cell.config = dict(cell.config, **config)
    return cell


def port_predictive(cell, x, seed, samples):
    from bayestpu_torch.core.rng import sample_seeds
    from bayestpu_torch.engine import sampler

    model = predict_closed.build_model(cell)
    model.load_state_dict(predict_closed.params_of(cell, SEED, "cpu"))
    seeds = sample_seeds(seed, samples, model.num_sites)
    with torch.no_grad():
        p = sampler.predictive(model, x, seeds)
    return {"probs": p.probs, "var": p.var, "entropy": p.entropy}


def reference_predictive(cell, x, seed, samples, num):
    ref = cell.reference
    pairs = common.sample_pairs(seed, samples, ref.num_sites(cell.config))
    params = predict_closed.params_of(cell, SEED, "cpu")
    with torch.no_grad():
        return common.predictive(ref.forward(params, x, pairs, cell.config,
                                             num))


def widest(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def test_vgg_f32_equals_reference():
    cell = cell_with("vgg11_me_bf16.predict_b128", dtype="float32")
    x = weights.make_images(SEED, 1, 3, (32, 32, 3), "cpu")[0]
    got = port_predictive(cell, x, 77, 4)
    ref = reference_predictive(cell, x, 77, 4, common.Numerics())
    assert widest(got, ref) < 2e-5


def test_vgg_bf16_within_limits():
    cell = harness.load_cell(ROOT, "vgg11_me_bf16.predict_b128")
    x = weights.make_images(SEED, 1, 3, (32, 32, 3), "cpu")[0]
    got = port_predictive(cell, x, 78, 10)
    ref = reference_predictive(cell, x, 78, 10, common.Numerics())
    gaps = predict_closed.gaps({0: got}, {0: ref})
    assert 0 < gaps["probs_gap"] <= cell.limits["probs_gap"]
    assert all(gaps[k] <= cell.limits[k] for k in gaps)


def test_resnet_int8_against_reference_and_control():
    """The int8 model against the reference on the ap_fixed<8,0> grid
    (only the stem's bf16 conv differs), and the 4-bit control far off."""
    cell = harness.load_cell(ROOT, "resnet18_me_int8.predict_b128")
    x = weights.make_images(SEED, 1, 2, (32, 32, 3), "cpu")[0]
    got = port_predictive(cell, x, 79, 3)
    ref = reference_predictive(cell, x, 79, 3,
                               predict_closed.numerics(cell, False))
    ctl = reference_predictive(cell, x, 79, 3,
                               predict_closed.numerics(cell, True))
    assert widest(got, ref) < 0.2 * widest(ctl, ref)
    assert all(v <= cell.limits[k] for k, v in
               predict_closed.gaps({0: got}, {0: ref}).items())


def test_training_step_f32_equals_reference():
    cell = cell_with("vgg11_me_bf16.train_b4096", dtype="float32")
    cell.traffic = dict(cell.traffic, batch=16, pool=3)
    st = train_steps.setup(cell, SEED, torch.device("cpu"))
    train_steps.release(st)
    gaps = train_steps.gaps(st.kept, train_steps.reference_steps(st))
    assert gaps["loss_gap"] < 1e-4 and gaps["grad_gap"] < 1e-3
    assert gaps["change_gap"] < 1e-3 and gaps["grad_dir_gap"] < 1e-5


def test_seed_pairs_match_the_port():
    from bayestpu_torch.core.rng import sample_seeds, step_seeds

    for seed in (0, 5, 2 ** 31 + 3, -7, 2 ** 40 + 1):
        assert torch.equal(common.sample_pairs(seed, 10, 5),
                           sample_seeds(seed, 10, 5))
        assert torch.equal(common.step_pairs(seed, 12, 5),
                           step_seeds(seed, 12, 5))


def test_configs_are_data():
    for f in (ROOT / "perfbench/configs").glob("*.json"):
        c = json.loads(f.read_text())
        assert c["reduced"] == [] and c["source"].startswith("https://")
