"""pytest settings of portbench's own tests (CPU; the card tests are
marked `cuda` and skip without a card).  Run from the repository root:

    python -m pytest portbench/tests -q
"""

import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
    torch.set_num_threads(2)
