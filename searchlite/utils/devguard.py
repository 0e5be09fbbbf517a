"""Backend check for device-measurement tools.

A tool that times the device must run on the GPU. ``guard_backend``
refuses to go on when JAX's default backend is anything else, unless
the run was pinned to the CPU on purpose with ``JAX_PLATFORMS=cpu``
(tests, host-side A/Bs). A CPU number is never recorded as a device
number.
"""

from __future__ import annotations

import os
import sys


def guard_backend(tool: str = "") -> str:
    """Return the default backend name; exit(3) when it is not the GPU
    and ``JAX_PLATFORMS=cpu`` was not set explicitly."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu" or os.environ.get("JAX_PLATFORMS") == "cpu":
        return backend
    print(f"{tool or 'device tool'}: the default JAX backend is "
          f"{backend!r}, not 'gpu'. Refusing to record its numbers as "
          "device measurements; set JAX_PLATFORMS=cpu for a host-side "
          "run.", file=sys.stderr, flush=True)
    raise SystemExit(3)
