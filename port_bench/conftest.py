"""pytest settings of the benchmark's own tests (port_bench/tests/):

    python -m pytest port_bench/tests -q -p no:cacheprovider

The `card` marker names a test that needs an NVIDIA card; such a test
decides inside itself whether one is present and skips without it."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips inside the test without one")
