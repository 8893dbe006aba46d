"""``utils/compile_cache.enable_compile_cache``: the kernel libraries'
path (``ops/cuda/build.KernelLibrary.library_path``) and the native
fusion library's build follow it to the directory given, else to
``SLOTVPS_COMPILE_CACHE``, else to ``slotvps_tpu_torch/_build/``."""

import pytest

from slotvps_tpu_torch import native
from slotvps_tpu_torch.ops.cuda.build import KernelLibrary
from slotvps_tpu_torch.utils import compile_cache


@pytest.fixture
def restore():
    yield
    compile_cache.enable_compile_cache(str(compile_cache.DEFAULT_DIR))


def _lib():
    return KernelLibrary("slot_attention", lambda lib: None)


def test_enable_compile_cache_moves_both_builds(tmp_path, restore,
                                                monkeypatch):
    monkeypatch.delenv("SLOTVPS_COMPILE_CACHE", raising=False)
    assert _lib().library_path().parent == compile_cache.DEFAULT_DIR
    assert compile_cache.enable_compile_cache(str(tmp_path)) == tmp_path
    assert _lib().library_path().parent == tmp_path
    assert native.available()
    assert [p.name.startswith("libslotvps_fusion_") and p.suffix == ".so"
            for p in tmp_path.iterdir()] == [True]


def test_enable_compile_cache_reads_the_variable(tmp_path, restore,
                                                 monkeypatch):
    monkeypatch.setenv("SLOTVPS_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.enable_compile_cache() == tmp_path / "env"
    assert compile_cache.build_dir() == tmp_path / "env"
    monkeypatch.delenv("SLOTVPS_COMPILE_CACHE")
    assert compile_cache.enable_compile_cache() == compile_cache.DEFAULT_DIR
