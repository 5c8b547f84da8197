"""Where a kernel's source builds to (``repro_torch.kernels.build``).

The library's directory is keyed on every file beside the source, so a
header that the ``.cu`` includes is part of the key: editing it must
move the library, or a stale build would be loaded.  Nothing is
compiled here.
"""
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as fa_kernel


def _csrc(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\nextern "C" int f();\n')
    (csrc / "k.cuh").write_text("constexpr int kTile = 64;\n")
    return csrc


def test_editing_a_sibling_header_moves_the_library(tmp_path):
    csrc = _csrc(tmp_path)
    before = build.library_path(csrc / "k.cu")
    (csrc / "k.cuh").write_text("constexpr int kTile = 128;\n")
    after = build.library_path(csrc / "k.cu")
    assert after != before
    assert after.name == before.name == "libk.so"
    assert after.parent.parent == build.BUILD_ROOT


def test_unchanged_sources_keep_the_library(tmp_path):
    csrc = _csrc(tmp_path)
    first = build.library_path(csrc / "k.cu")
    assert build.library_path(csrc / "k.cu") == first
    # a new file beside the source is part of the key too
    (csrc / "other.cuh").write_text("// more\n")
    assert build.library_path(csrc / "k.cu") != first


def test_two_sources_in_one_directory_build_apart(tmp_path):
    csrc = _csrc(tmp_path)
    (csrc / "j.cu").write_text('#include "k.cuh"\n')
    assert (build.library_path(csrc / "j.cu").parent
            != build.library_path(csrc / "k.cu").parent)


def test_flash_attention_header_is_beside_its_source():
    """The tensor-core kernel lives in a header that the ``.cu``
    includes, in the directory ``library_path`` hashes."""
    header = fa_kernel.SOURCE.parent / "flash_attention_wgmma.cuh"
    assert header.is_file()
    assert f'#include "{header.name}"' in fa_kernel.SOURCE.read_text()
