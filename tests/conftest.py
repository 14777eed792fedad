"""Shared pytest configuration.

Pin the legacy XLA:CPU runtime for the test suite: the new thunk
runtime that jaxlib 0.4.36 enables by default segfaults inside
``backend_compile`` once a single process has accumulated a few
hundred compiled executables (deterministically reproducible on the
full suite — the ``lax.scan`` in ``tiered/kvcache._apply_plan`` that
happens to be the ~200th compilation dies, regardless of which test
triggers it; every file passes in isolation).  The flag must be in the
environment before the first jax backend initialisation, which is why
it lives here rather than in any test module — conftest is imported
before test collection touches jax.  Benchmarks and examples compile
far fewer programs per process and don't need it.
"""

import os

_FLAG = "--xla_cpu_use_thunk_runtime=false"
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " " + _FLAG).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one (on the "
        "card: python -m pytest -m cuda tests/test_torch_cuda.py)")
