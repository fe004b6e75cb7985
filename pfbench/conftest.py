"""pytest settings of the benchmark's own tests (`python -m pytest
pfbench`): the `cuda` marker of tests that need a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run them "
        "on the card with `python -m pytest -m cuda pfbench`")
