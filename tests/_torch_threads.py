"""The port's test modules run on one intra-op torch thread.

A port test module imports ``one_thread`` (an autouse fixture of module
scope): the plain versions run many small torch ops, and under the parallel
test run an op split over every core's threads waits on all of them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tests on one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
