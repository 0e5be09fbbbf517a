"""End-to-end test of the real C ABI (`native/slt_ffi.cpp`): compiles a
C host program against native/searchlite.h, links
libsearchlite.so, and drives open → add → search → cursor →
close from C with no Python on the host side."""

import json
import os
import subprocess

import pytest

from searchlite.native import build_ffi_lib

C_HOST = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "searchlite.h"

int main(int argc, char** argv) {
  if (argc < 2) return 10;
  searchlite_handle h = searchlite_index_open(argv[1], 1);
  if (h == 0) return 11;
  if (searchlite_add_json(h, "{\"_id\":\"1\",\"body\":\"hello gpu world\"}"))
    return 12;
  if (searchlite_add_json(h, "{\"_id\":\"2\",\"body\":\"another doc here\"}"))
    return 13;
  if (searchlite_add_json(h, "not json") != -1) return 14;
  if (searchlite_commit(h)) return 15;

  char out[65536];
  long long n = searchlite_search(h, "hello", 5, NULL, NULL,
                                  out, sizeof out);
  if (n <= 0 || n >= (long long)sizeof out) return 16;
  printf("QSTRING %s\n", out);

  n = searchlite_search(h, "{\"type\": \"term\", \"field\": \"body\", "
                        "\"value\": \"doc\"}",
                        5, NULL, NULL, out, sizeof out);
  if (n <= 0) return 17;
  printf("QNODE %s\n", out);

  /* truncation contract: required size returned, output clipped */
  char tiny[8];
  long long full = searchlite_search(h, "hello", 5, NULL, NULL,
                                     tiny, sizeof tiny);
  if (full <= (long long)sizeof tiny || strlen(tiny) != 7) return 18;

  /* aggs on the fast-field-less default schema: validation error → -1
     (same sentinel the reference FFI uses for search errors) */
  if (searchlite_search(h, "hello", 5, NULL,
                        "{\"c\": {\"type\": \"value_count\", "
                        "\"field\": \"body\"}}",
                        out, sizeof out) != -1)
    return 20;

  if (searchlite_search(0, "hello", 5, NULL, NULL, out, sizeof out) != -1)
    return 19;
  searchlite_index_close(h);
  return 0;
}
"""


@pytest.fixture(scope="module")
def ffi_lib():
    path = build_ffi_lib()
    if path is None:
        pytest.skip("no C toolchain / Python.h")
    return path


def test_c_host_end_to_end(ffi_lib, tmp_path):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc = tmp_path / "host.c"
    csrc.write_text(C_HOST)
    exe = tmp_path / "host"
    subprocess.run(
        ["gcc", "-O1", str(csrc), "-o", str(exe),
         f"-I{os.path.join(here, 'native')}",
         str(ffi_lib), f"-Wl,-rpath,{os.path.dirname(ffi_lib)}"],
        check=True, capture_output=True, timeout=120)

    idx_dir = tmp_path / "idx"
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([str(exe), str(idx_dir)], capture_output=True,
                          text=True, timeout=560, env=env)
    assert proc.returncode == 0, (proc.returncode, proc.stdout, proc.stderr)

    lines = dict(line.split(" ", 1) for line in
                 proc.stdout.strip().splitlines())
    qstring = json.loads(lines["QSTRING"])
    assert [h["doc_id"] for h in qstring["hits"]] == ["1"]
    assert qstring["hits"][0]["fields"]["body"] == "hello gpu world"
    qnode = json.loads(lines["QNODE"])
    assert [h["doc_id"] for h in qnode["hits"]] == ["2"]
