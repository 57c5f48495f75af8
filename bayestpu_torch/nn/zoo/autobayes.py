"""The autobayes float model zoo as converter layer specs (counterpart of
``bayestpu/nn/zoo/autobayes.py``): the seven spec builders, ``get_specs``
and their registration as ready-built ``Sequential`` models.

Spec sources (file:line of the reference's ``autobayes/models/``):
LeNet1 (``LeNet.py:12-32``), LeNet5 (``:35-67``), LeNet (``:69-100``),
AlexNet (``AlexNet.py:6-29``), the ThreeLayer jet-tagging MLP
(``ThreeLayer.py:6-17``), MinimalCNN and ReducedCNN.

A registered builder takes ``bayes``, ``quant``, ``num_classes`` (which
replaces the last Dense), ``specs_kw`` and ``dtype`` as JAX's does
(``autobayes.py:85-106``), converts the specs when ``bayes.kind`` is not
``NONE``, and accepts and ignores every other keyword, ``fused`` among
them: JAX builds the ``Sequential`` without it, and so does the port.
Flax infers the Dense widths from the first input; the port takes
``input_shape`` (default ``INPUT_SHAPES[name]``).
"""

from __future__ import annotations

from bayestpu_torch.core.config import DropoutKind
from bayestpu_torch.nn.convert import Act, C, D, Flatten, Pool
from bayestpu_torch.nn.zoo.registry import register_model


def lenet1_specs():
    return [C(4, (5, 5), padding="VALID"), Pool("max", 2),
            C(8, (5, 5), padding="VALID"), Pool("max", 2),
            Flatten(), D(10)]


def lenet5_specs(include_top: bool = True):
    specs = [C(20, (5, 5), padding="SAME"), Pool("max", 2),
             C(50, (5, 5), padding="SAME"), Pool("max", 2)]
    if include_top:
        specs += [Flatten(), D(500), Act(), D(10)]
    return specs


def lenet_specs_autobayes():
    # models/LeNet.py:69-100: the converter-benchmark LeNet
    return [C(20, (5, 5), padding="SAME"), Pool("max", 2),
            C(20, (5, 5), padding="SAME"), Pool("max", 7),
            Flatten(), D(100), Act(), D(10)]


def alexnet_specs(num_classes: int = 10):
    return [
        C(96, (11, 11), (4, 4), "VALID"), Act(), Pool("max", 3, 2),
        C(256, (5, 5)), Act(), Pool("max", 3, 2),
        C(384, (3, 3)), Act(),
        C(384, (3, 3)), Act(),
        C(256, (3, 3)), Act(), Pool("max", 3, 2),
        Flatten(), D(4096), Act(), D(4096), Act(), D(num_classes),
    ]


def three_layer_specs():
    return [D(64), Act(), D(32), Act(), D(32), Act(), D(5)]


def minimal_cnn_specs(filters: int = 16, dense_out: int = 10):
    return [C(filters, (3, 3)), Act(), Pool("max", 2),
            Flatten(), D(dense_out)]


def reduced_cnn_specs():
    return [C(8, (3, 3)), Act(), Pool("max", 2),
            C(16, (3, 3)), Act(), Pool("max", 2),
            Flatten(), D(32), Act(), D(10)]


_SPEC_BUILDERS = {
    "lenet1": lenet1_specs,
    "lenet5": lenet5_specs,
    "lenet_autobayes": lenet_specs_autobayes,
    "alexnet": alexnet_specs,
    "three_layer": three_layer_specs,
    "minimal_cnn": minimal_cnn_specs,
    "reduced_cnn": reduced_cnn_specs,
}

# the input each model is built for unless the caller names another: MNIST
# shapes for the small convnets, ImageNet's 224x224x3 for AlexNet (fc6 then
# takes 5x5x256 = 6400 features), the 16 jet features for ThreeLayer
INPUT_SHAPES = {"lenet1": (28, 28, 1), "lenet5": (28, 28, 1),
                "lenet_autobayes": (28, 28, 1), "alexnet": (224, 224, 3),
                "three_layer": (16,), "minimal_cnn": (28, 28, 1),
                "reduced_cnn": (28, 28, 1)}


def get_specs(name: str, **kw):
    return _SPEC_BUILDERS[name.lower()](**kw)


def _register(name: str, builder):
    @register_model(name)
    def build(bayes=None, quant=None, num_classes=None, fused=False,
              specs_kw=None, dtype=None, input_shape=None, **_ignored):
        from bayestpu_torch.nn.convert import Sequential, convert_to_bayesian
        specs = list(builder(**(specs_kw or {})))
        if num_classes is not None and isinstance(specs[-1], D):
            specs[-1] = D(num_classes)
        if bayes is not None and bayes.kind is not DropoutKind.NONE:
            specs = convert_to_bayesian(specs, bayes)
        extra = {}
        if quant is not None:
            extra["quant"] = quant
        if dtype is not None:
            extra["dtype"] = dtype
        return Sequential(specs, input_shape or INPUT_SHAPES[name], **extra)
    return build


for _name, _builder in _SPEC_BUILDERS.items():
    _register(_name, _builder)
