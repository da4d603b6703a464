"""Test env: CPU backend with 8 virtual devices (SURVEY.md §4 item 5).

Must run before any jax import.  Small deterministic renders run on CPU
through the XLA reference intersectors; the GPU kernels run here in
Pallas interpret mode, and the multi-device tests use the 8 virtual host
devices.  The kernels compiled for the card are exercised by
``chip_smoke.py`` on a GPU, not by pytest.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """The full suite once segfaulted inside XLA-CPU's
    backend_compile_and_load after ~a hundred compiled programs in one
    process (jaxlib 0.9).  Dropping compiled executables at module
    boundaries keeps the compiler's live-program count bounded; costs a
    few recompiles of cross-module shared programs."""
    yield
    jax.clear_caches()
