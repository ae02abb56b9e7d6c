"""CPU tests of the benchmark; tests marked ``cuda`` need the card and
skip without it (decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
