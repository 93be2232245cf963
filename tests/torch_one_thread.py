"""A module-scoped fixture that runs a test module's torch on one intra-op
thread: many small CPU ops would otherwise spin torch's pool against the
other test workers on the same cores. A module turns it on by importing it:

    from torch_one_thread import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while the importing module runs; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
