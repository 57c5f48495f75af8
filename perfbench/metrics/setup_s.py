"""setup_s: from the process's start to the first timed request or step
(imports, the kernels' build on a checkout's first run, weights and inputs
made on the card, warm-up and graph capture), on the host's clock."""


def read(run):
    return run.setup_s
