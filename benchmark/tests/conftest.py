"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from
the root of a checkout. Tests marked ``cuda`` need the card and skip
without one, decided inside the test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA sm_90 card (skips without one)")
