"""The port's CPU tests' thread pool: torch on two threads per module.

The Tier-1 command runs six workers that share the host's cores; a worker
with torch's default pool (one thread a core) contends with the other five,
and tests/test_torch_train.py's steps ran 15-20 times slower so than in one
process alone.  A test module imports ``two_threads`` (an autouse fixture)
to take two threads for its duration; a test whose float32 result is held
to a bound that the default pool's summation order meets takes
``default_threads`` as well.
"""

import pytest
import torch

# The process's pool before any module took two threads
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def default_threads():
    """The process's default pool for one test, two threads again after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(before)

