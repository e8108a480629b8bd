"""The port's kernel build cache (privacy_preserve_federated_asr_tpu_torch/
ops/cuda_build.py): a library's name hashes its source, every shared header
and the nvcc flags, so an edit to any of them builds anew and a stale
library is never loaded. Needs no nvcc: only the names are computed."""

import pytest

from privacy_preserve_federated_asr_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n__global__ void f() {}\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nconstexpr int kD = 64;\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    return tmp_path


def test_library_path_is_stable(csrc):
    path = cuda_build.library_path("kern")
    assert path == cuda_build.library_path("kern")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libkern-")
    assert not path.exists()  # naming builds nothing


@pytest.mark.parametrize("change", ["header", "new header", "source", "flags"])
def test_library_path_follows_every_input(csrc, monkeypatch, change):
    before = cuda_build.library_path("kern")
    if change == "header":
        (csrc / "common.cuh").write_text("#pragma once\nconstexpr int kD = 128;\n")
    elif change == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif change == "source":
        (csrc / "kern.cu").write_text('#include "common.cuh"\n__global__ void g() {}\n')
    else:
        monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("kern") != before


def test_port_sources_share_one_header():
    """Every csrc/*.cu is built (listed in SOURCES); the attention kernels B1
    and B2 share flash_common.cuh (the CTC kernels share nothing with them)."""
    srcs = [cuda_build.CSRC / f"{n}.cu" for n in cuda_build.SOURCES]
    assert sorted(p.name for p in cuda_build.CSRC.glob("*.cu")) == sorted(p.name for p in srcs)
    for name in ("flash_fwd", "flash_bwd"):
        assert '#include "flash_common.cuh"' in (cuda_build.CSRC / f"{name}.cu").read_text()
