import os
import sys

# tests run single-device (the dry-run forces 512 devices in its OWN process)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-chain statistical tests (run in the non-blocking CI job; "
        "deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (skips without one; run these on the GPU)",
    )
