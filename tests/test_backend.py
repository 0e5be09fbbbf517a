"""Where the program runs: the compile-cache placement, the backend check
of the device tools, the host tier's default, and the device storage
dtypes on a GPU in each precision mode."""

import os

import jax
import jax.numpy as jnp
import pytest

import searchlite
from searchlite.api.reader import _host_tier_device
from searchlite.ops.precision import dense_store_dtype, impacts_store_dtype
from searchlite.utils.devguard import guard_backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env, want", [
    ("/some/cache", "/some/cache"),
    (None, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert searchlite.compile_cache_dir() == want


@pytest.mark.parametrize("env", ["/some/cache", None])
def test_enable_compile_cache_sets_no_other_dir(monkeypatch, env):
    """With the variable set the code leaves the cache to JAX; unset, it
    points the live config at the checkout's .jax_cache."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("SEARCHLITE_COMPILE_CACHE", raising=False)
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    searchlite._enable_compile_cache()
    want = [] if env else [("jax_compilation_cache_dir",
                            os.path.join(REPO, ".jax_cache"))]
    assert calls == want
    assert os.environ.get("JAX_COMPILATION_CACHE_DIR") == env


@pytest.mark.parametrize("backend, platforms, ok", [
    ("gpu", None, True),
    ("cpu", "cpu", True),
    ("cpu", None, False),
    ("cpu", "cuda,cpu", False),
])
def test_guard_backend(monkeypatch, backend, platforms, ok):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    if ok:
        assert guard_backend("t") == backend
    else:
        with pytest.raises(SystemExit) as e:
            guard_backend("t")
        assert e.value.code == 3


def test_host_tier_off_by_default_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("SEARCHLITE_HOST_TIER_DOCS", raising=False)
    monkeypatch.delenv("SEARCHLITE_HOST_TIER", raising=False)
    assert _host_tier_device(10) is None


def test_host_tier_opt_in_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("SEARCHLITE_HOST_TIER_DOCS", "100")
    dev = _host_tier_device(10)
    assert dev is not None and dev.platform == "cpu"
    assert _host_tier_device(100) is None


@pytest.mark.parametrize("mode, impacts, dense", [
    ("", jnp.bfloat16, jnp.bfloat16),
    ("f32", jnp.bfloat16, jnp.bfloat16),
    ("f32_strict", jnp.float32, jnp.float32),
    ("bf16", jnp.bfloat16, jnp.bfloat16),
])
def test_store_dtypes_on_gpu(monkeypatch, mode, impacts, dense):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("SEARCHLITE_DEVICE_IMPACTS", raising=False)
    monkeypatch.setenv("SEARCHLITE_PRECISION", mode)
    assert impacts_store_dtype("gpu") == impacts
    assert dense_store_dtype(mode or "f32") == dense


def test_cpu_backend_keeps_f32_storage(monkeypatch):
    monkeypatch.delenv("SEARCHLITE_DEVICE_IMPACTS", raising=False)
    monkeypatch.delenv("SEARCHLITE_PRECISION", raising=False)
    assert impacts_store_dtype("cpu") == jnp.float32
    assert dense_store_dtype("f32") == jnp.float32
