"""The port's CUDA build bookkeeping, on the CPU (nothing is compiled).

``build.library_path`` names a source's library by a hash of the source,
the headers of ``csrc/`` it includes and the nvcc flags, so that an edited
header rebuilds every source that includes it instead of reusing a stale
library.
"""
from repro_torch.kernels import build


def _csrc(tmp_path, monkeypatch, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(build, "CSRC", tmp_path)


def test_headers_follows_quoted_includes_of_csrc(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch, {
        "k.cu": '#include <cuda_runtime.h>\n#include "a.cuh"\nint f();\n',
        "a.cuh": '#pragma once\n  #  include "b.cuh"\n#include "missing.cuh"\n',
        "b.cuh": "#pragma once\n",
    })
    assert build.headers("k.cu") == [tmp_path / "a.cuh", tmp_path / "b.cuh"]


def test_library_path_changes_with_an_included_header(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch, {
        "k.cu": '#include "a.cuh"\nint f();\n',
        "a.cuh": '#include "b.cuh"\n',
        "b.cuh": "// one\n",
        "other.cu": "int g();\n",
    })
    first, other = build.library_path("k.cu"), build.library_path("other.cu")
    assert build.library_path("k.cu") == first
    (tmp_path / "b.cuh").write_text("// two\n")
    assert build.library_path("k.cu") != first
    assert build.library_path("other.cu") == other
    assert first.name.startswith("k-") and first.suffix == ".so"


def test_the_tensor_core_sources_share_the_hopper_header():
    for source in ("flash_attention.cu", "ssd_scan.cu"):
        assert build.CSRC / "hopper.cuh" in build.headers(source)
    assert build.headers("qsgd.cu") == []
