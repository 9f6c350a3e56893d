"""Settings of the tests under ``tests/``."""


def pytest_configure(config):
    config.addinivalue_line("markers", "h100: needs an NVIDIA H100 (CUDA); skipped elsewhere")
