"""The benchmark's CPU tests run with two torch threads."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
