"""The port test modules' share of the CPU: one intra-op thread budget.

pytest-xdist runs several test processes at once, and torch gives each
one a thread per core, so six workers on eight cores run 48 busy
threads; the port's small models and training steps then spend most of
their time waiting for a core. Every ``tests/test_torch_port_*.py``
module takes the fixture below by importing it::

    from port_threads import thread_budget  # noqa: F401

(pytest registers a fixture found in a test module's namespace for that
module). Importing sets nothing: the JAX test files that the same worker
runs keep torch's default.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def thread_budget():
    """Runs the module's tests on this process's share of the cores,
    ``os.cpu_count()`` over the xdist workers (``PYTEST_XDIST_WORKER_COUNT``,
    1 without xdist), at least 1, and restores the count found before.
    A file run alone keeps every core."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)
