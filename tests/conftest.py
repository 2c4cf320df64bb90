import os
# Tests run on CPU with 8 virtual devices so sharding logic is exercised
# without a multi-GPU host (the standard JAX fake-backend trick; SURVEY.md
# section 4). The platform is pinned to the CPU unless JAX_PLATFORMS names
# another, so a machine with a GPU still tests the CPU paths by default.
# Tests that need the card carry the `gpu` marker and decide in a fixture:
#   JAX_PLATFORMS=cuda python -m pytest -m gpu -o addopts="" tests/
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# Persistent compile cache: wavefront graphs are large; recompiling them on
# every pytest run would dominate test time. Each xdist worker gets its own
# host-keyed sub-directory of the checkout's cache (prt/utils/jax_cache.py):
# two workers writing one cache dir was the prime suspect for rare in-run
# worker crashes in the persistent-cache writer. Worker ids are stable
# (gw0/gw1), so each sub-cache still persists across runs.
from prt.utils.jax_cache import cpu_cache_dir
jax.config.update("jax_compilation_cache_dir", cpu_cache_dir(
    "tests_" + os.environ.get("PYTEST_XDIST_WORKER", "main")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
