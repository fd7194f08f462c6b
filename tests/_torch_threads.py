"""Two torch intra-op threads while a port test module runs.

The tier-1 run puts six test processes on the machine's cores at once; at
torch's default of one intra-op thread a core, their OpenMP threads spin
against each other, and a test of small eager ops ran ~25x slower in the
suite than alone. A module imports the fixture to use it:

    from _torch_threads import torch_threads  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
