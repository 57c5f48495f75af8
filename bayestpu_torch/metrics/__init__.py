from bayestpu_torch.metrics import ece, entropy, flops, kde  # noqa: F401
from bayestpu_torch.metrics.kde import ece_kde  # noqa: F401
from bayestpu_torch.metrics.ece import (  # noqa: F401
    accuracy,
    ece_bins,
    ece_equal_width,
    ece_from_bins,
    ece_hist,
    eval_metrics,
    nll,
)
from bayestpu_torch.metrics.entropy import (  # noqa: F401
    mean_predictive_entropy)
