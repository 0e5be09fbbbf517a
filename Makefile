# Developer entry points (the reference uses a Justfile; same spirit).

PY ?= python

.PHONY: test test-fast native ffi bench smoke micro dryrun clean

test:            ## full suite (CPU backend, 8-device virtual mesh)
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

test-fast:       ## suite minus the slow embedded-interpreter FFI test
	$(PY) -m pytest tests/ -q --deselect tests/test_ffi.py

native:          ## build the C++ ingest accelerator into the cache dir
	$(PY) -c "from searchlite.native import get_lib; \
	          assert get_lib() is not None, 'toolchain missing'; \
	          print('slt_ingest.so ok')"

ffi:             ## build the C embedding ABI (libsearchlite.so)
	$(PY) -c "from searchlite.native import build_ffi_lib; \
	          p = build_ffi_lib(); assert p, 'toolchain missing'; print(p)"

bench:           ## headline benchmark (GPU only; one JSON line)
	$(PY) bench.py

smoke:           ## main path once on the GPU, every answer gated
	$(PY) chip_smoke.py

micro:           ## criterion-style micro scenarios
	$(PY) benches/micro.py

dryrun:          ## compile-check entry + multi-chip sharding on CPU mesh
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	$(PY) __graft_entry__.py

clean:
	rm -rf .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
