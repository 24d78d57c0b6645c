"""One intra-op torch thread for each of the port's CPU tests, an autouse
fixture that a test file opts into by importing it:

    from tests.torch_threads import torch_one_thread  # noqa: F401

torch starts one intra-op thread per core. Under pytest-xdist's six
workers on an eight-core host that is 48 threads, and the small ops these
tests run wait on each other: the 3xTF32 emulation file took 260 s there
against 1 s with one thread, a tiny-SwinIR training file 318 s against 105.
One thread also makes a test's sums independent of the host's cores. A
test whose limits were set at the default count and do not hold at one
(the order of a parallel reduction moves its last digits) is named in its
module's TORCH_DEFAULT_THREADS and keeps the default: the three-step
SRModel comparisons of GAN training and of DAT, held to 1e-5.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def torch_one_thread(request):
    if request.node.originalname in getattr(request.module, "TORCH_DEFAULT_THREADS", ()):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
