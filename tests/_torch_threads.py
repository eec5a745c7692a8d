"""The port's test modules cap torch's intra-op threads: the test run's
workers share the host's cores, and more threads than cores spin. Each
`tests/test_torch_*.py` module imports the fixture below, which then runs
once per module (autouse)."""

import pytest

from distributed_pytorch_from_scratch_tpu_torch.runtime.launch import (
    torch_threads)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for the importing module's tests."""
    with torch_threads(2):
        yield
