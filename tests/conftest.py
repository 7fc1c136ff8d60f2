"""Registers the marker of tests that need an NVIDIA GPU."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test skips itself where none is present",
    )
