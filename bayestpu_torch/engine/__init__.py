from bayestpu_torch.engine import sampler  # noqa: F401
from bayestpu_torch.engine.sampler import (  # noqa: F401
    mc_logits, mc_moments, predictive)


def __getattr__(name):
    # lazy, as in the JAX package: engine.engine imports the metrics
    import importlib
    if name == "BayesEngine":
        return importlib.import_module(
            "bayestpu_torch.engine.engine").BayesEngine
    if name in ("inference", "engine"):
        return importlib.import_module(f"bayestpu_torch.engine.{name}")
    raise AttributeError(name)
