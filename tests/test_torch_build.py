"""The port's kernel build and variant selection, on the CPU (no nvcc,
no GPU): which kernel variant each call takes, that the launch counts
reset by variant, and that a library's name follows every header its
sources include, so that an edited header is rebuilt."""

import re
import shutil

import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import flash_variant
from repro_torch.kernels.matmul_tiled import matmul_variant


@pytest.mark.parametrize("m,k,n,want", [
    (1024, 2560, 7168, "wgmma"),      # one ring step of the yi-34b fused ring
    (1000, 2560, 7000, "wgmma"),      # ragged M and N, 16-byte rows
    (1000, 2552, 7000, "wgmma"),      # a K tail that is not a multiple of 64
    (128, 0, 64, "wgmma"),            # K == 0
    (1000, 2555, 7001, "wmma_masked"),
    (100, 37, 136, "wmma_masked"),    # rows of A not 16-byte aligned
    (100, 40, 132, "wmma_masked"),    # rows of B not 16-byte aligned
])
def test_matmul_variant_by_shape(m, k, n, want):
    assert matmul_variant(torch.bfloat16, k, n) == want


def test_matmul_variant_by_dtype_and_alignment():
    assert matmul_variant(torch.float32, 2560, 7168) == "simt_f32"
    assert matmul_variant(torch.float32, 2555, 7001) == "simt_f32"
    # a base pointer off a 16-byte boundary (a view into a larger buffer)
    assert matmul_variant(torch.bfloat16, 2560, 7168, x_ptr=8) == \
        "wmma_masked"
    assert matmul_variant(torch.bfloat16, 2560, 7168, w_ptr=2) == \
        "wmma_masked"
    assert matmul_variant(torch.bfloat16, 2560, 7168, 4096, 8192) == "wgmma"


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"),      # minicpm-2b
    (torch.bfloat16, 128, "wgmma"),     # GQA 32/8 at D 128 (synthetic)
    (torch.bfloat16, 16, "mma_sync"),   # the reduced configs
    (torch.bfloat16, 32, "mma_sync"),
    (torch.bfloat16, 96, "mma_sync"),   # phi3-mini-3.8b
    (torch.bfloat16, 160, "mma_sync"),  # mistral-nemo-12b
    (torch.float32, 96, "simt_f32"),
    (torch.float32, 160, "simt_f32"),
    (torch.float32, 64, "simt_f32"),
    (torch.float32, 128, "simt_f32"),
    (torch.float32, 16, "simt_f32"),
])
def test_flash_variant_by_dtype_and_head_dim(dtype, d, want):
    assert flash_variant(dtype, d) == want


def test_reset_zeroes_every_variant_count():
    wrappers = [ops.WRAPPERS["matmul_tiled"], ops.WRAPPERS["flash_attention"]]
    for fn in wrappers:
        fn.launches = 3
        for variant in fn.variant_launches:
            fn.variant_launches[variant] = 2
    ops.reset_launch_counts()
    assert ops.launch_counts()["matmul_tiled"] == 0
    assert ops.variant_launch_counts() == {
        "matmul_tiled": {"simt_f32": 0, "wmma_masked": 0, "wgmma": 0},
        "flash_attention": {"simt_f32": 0, "mma_sync": 0, "wgmma": 0}}


def test_check_launch_names_the_failure():
    build.check_launch("k", 0)
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        build.check_launch("k", 700)
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled .* 1$"):
        build.check_launch("k", build.ENCODE_ERROR + 1)


def _local_includes(path):
    return re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)


def test_every_local_include_is_hashed():
    """HEADERS lists exactly the local headers each kernel's sources
    include, so library_path sees every file the build reads."""
    pkg = build._PKG
    for name, sources in build.SOURCES.items():
        found = {f"csrc/{inc}" for rel in sources
                 for inc in _local_includes(pkg / rel)}
        assert found == set(build.HEADERS.get(name, ())), name


@pytest.mark.parametrize("name", ["matmul_tiled", "flash_attention"])
def test_library_path_follows_the_header(tmp_path, monkeypatch, name):
    """On a copy of the sources: editing hopper.cuh renames the library
    of every kernel that includes it (a stale one is never reused), and
    an untouched tree keeps its name; a kernel without the header keeps
    its name too."""
    shutil.copytree(build._PKG / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(build, "_PKG", tmp_path)
    before = build.library_path(name)
    other = build.library_path("multi_add")
    assert build.library_path(name) == before
    header = tmp_path / "csrc" / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) != before
    assert build.library_path("multi_add") == other


def test_threads_loading_one_kernel_build_it_once(monkeypatch):
    """The ranks of a LocalComm grid reach a kernel together: ``load``
    builds it once for the process (two builds in one process would
    race on ``build_all``'s temporary file)."""
    import threading
    import time as _time

    calls = []

    def fake_build_all(names):
        calls.append(list(names))
        _time.sleep(0.05)
        return {n: build.BuildResult(n, build.BUILD_DIR / f"lib{n}.so", 0.0,
                                     "") for n in names}

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    got = [None] * 8

    def worker(i):
        got[i] = build.load("multi_add")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == [["multi_add"]]
    assert all(g is got[0] for g in got)
