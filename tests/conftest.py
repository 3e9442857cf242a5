# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 placeholders.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:  # container has no hypothesis wheel; fall back to the deterministic stub
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run on the card with -m cuda"
    )
