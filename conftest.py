"""Test-run hermeticity for both packages' suites.

``perf_model`` in both packages persists its host calibration under
``REPRO_FF_CACHE`` (else ``~/.cache/repro_ff``) and reads it back on every
cost-driven ``place``.  Left shared, a calibration written by one pytest
worker (any test that compiles a process-tier graph measures and caches
one) changes the widths another worker's placement tests see, depending on
which test reaches the disk first.  Each test process (the xdist controller
and every worker) therefore gets a private, empty cache directory, removed
when the process ends; a ``REPRO_FF_CACHE`` or ``REPRO_FF_CALIB_CACHE`` set
by the caller wins.
"""

import os
import shutil
import tempfile

# names the directory this hook made, so a worker that inherits it from the
# controller's environment replaces it instead of sharing it
_OWNED = "REPRO_FF_TEST_PRIVATE_CACHE"
_private_cache = None


def pytest_configure(config):
    global _private_cache
    inherited = os.environ.get("REPRO_FF_CACHE")
    if os.environ.get("REPRO_FF_CALIB_CACHE") or (
            inherited and inherited != os.environ.get(_OWNED)):
        return
    _private_cache = tempfile.mkdtemp(prefix="repro_ff_cache-")
    os.environ["REPRO_FF_CACHE"] = os.environ[_OWNED] = _private_cache


def pytest_unconfigure(config):
    if _private_cache is not None:
        shutil.rmtree(_private_cache, ignore_errors=True)
