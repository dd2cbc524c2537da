"""The benchmark's own tests (``python -m pytest portbench/tests``): its
manifest, arithmetic, reference and comparison on the CPU at toy sizes.
Card-only tests carry the ``gpu`` marker and skip without a card."""

import torch


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device; skips without one")
    torch.set_num_threads(2)
