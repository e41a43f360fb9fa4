"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the repository. Tests marked `card` need a CUDA device and skip,
with the reason, where there is none; each decides inside the test."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips on a machine without one")
