"""Shared test configuration.

``hypothesis`` is an optional dev dependency (requirements-dev.txt): the
property-based tests skip cleanly when it is absent, while the plain
parametrized tests in the same modules keep running.
"""

from __future__ import annotations

import pytest

try:
    import hypothesis  # noqa: F401
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False


def optional_hypothesis():
    """Return ``(given, settings, st)`` — real, or stubs that skip the test."""
    if HAVE_HYPOTHESIS:
        from hypothesis import given, settings, strategies as st
        return given, settings, st

    def given(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(reason="hypothesis not installed")(fn)
        return deco

    def settings(*_args, **_kwargs):
        return lambda fn: fn

    class _Strategies:
        def __getattr__(self, name):
            return lambda *a, **k: None

    return given, settings, _Strategies()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips (inside the test's "
        "fixture) where torch.cuda.is_available() is false")
