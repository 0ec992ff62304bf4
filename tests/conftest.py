def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips without one")
    # REPRO_SANITIZE=1: run the WHOLE suite with the runtime invariant
    # sanitizer installed (RingState monotonicity + lookup oracle,
    # BlockStore replication/tombstones, Replica slot conservation) —
    # the CI `sanitize` job sets it; see src/repro/analysis/sanitize.py
    # and DESIGN.md §14.
    from repro.analysis import sanitize
    if sanitize.enabled():
        sanitize.install()


def pytest_unconfigure(config):
    from repro.analysis import sanitize
    sanitize.uninstall()
