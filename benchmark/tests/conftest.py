"""The benchmark's tests: `python -m pytest benchmark/tests -q` from the
root of a checkout. Tests marked `cuda` need a card and skip without one
(on the card: `python -m pytest benchmark/tests -q -m cuda`)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
