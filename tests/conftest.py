import os

# Tests run on the single host CPU device (the 512-device override is ONLY
# for launch/dryrun.py). Keep XLA quiet and single-threaded-friendly.
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (kernel vs plain version); "
                   "skips without one")
