"""Test harness: force a local 8-device virtual CPU mesh so multi-device
sharding paths are exercised without accelerators (SURVEY §4 item 4).

JAX may already be imported when this runs, so the platform is set through
jax.config as well as the environment. Unit tests run on the local CPU;
tests that need the GPU carry the `gpu` marker and skip there. On a GPU
machine `SPH_TEST_GPU=1 python -m pytest tests -m gpu` leaves the platform
alone so those tests run.
"""

import os

ON_GPU = os.environ.get("SPH_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

from sphsim.utils.compile_cache import setup_persistent_cache  # noqa: E402

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set, else
# tests/.jax_cache/<host-fingerprint> (utils/compile_cache.py). Repeated
# pytest runs skip the cold compiles (dominated by the k=8 XLA dense twin,
# ~30 min cold on CPU).
_cache_dir = setup_persistent_cache(
    os.path.join(os.path.dirname(__file__), ".jax_cache"), per_host=True
)


def pytest_sessionstart(session):
    if ON_GPU:
        return
    assert jax.default_backend() == "cpu", (
        "tests must run on local CPU, got " + jax.default_backend()
    )
    assert jax.device_count() == 8
