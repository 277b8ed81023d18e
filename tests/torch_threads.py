"""One torch intra-op thread for a whole test module.

The tier-1 run puts six test workers on the machine's cores. Beside the
other busy workers, each of torch's intra-op threads spins for a core, and
a module of CPU torch work takes several times as long as on one thread
(the flagship train-steps CLI: 16 s on one thread, 123 s on eight with six
cores busy). A test module imports ``one_thread``; pytest runs it before
the module's other fixtures and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
