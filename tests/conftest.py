"""Shared test configuration.

If `hypothesis` is not installed (it is an optional dev dependency — see
requirements-dev.txt), register the deterministic fallback shim so the four
property-test modules still import and run a reduced deterministic sweep
instead of erroring at collection.
"""
import importlib.util
import pathlib
import sys

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _spec = importlib.util.spec_from_file_location(
        "hypothesis",
        pathlib.Path(__file__).with_name("_hypothesis_shim.py"))
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason without one")
