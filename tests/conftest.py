"""Test configuration: force an 8-device virtual CPU mesh so sharding
paths are exercised without accelerator hardware."""

import os

# Force the CPU backend for tests even when the machine has a GPU —
# sharding paths run on a virtual 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may have been imported before this file runs, so the env var alone
# is not enough — update the config directly too.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
