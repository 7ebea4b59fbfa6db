"""PyTorch port: import isolation from JAX, the explicit device, and the
modes that are not ported yet."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch as port
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models import (
    base,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
    cuda_build,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """Every module of the port, imported in a fresh interpreter (the test
    process itself already holds jax, see conftest.py), leaves jax out of
    sys.modules."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import {port.__name__} as p
        names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 14, names
        bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
                     or k.startswith("jaxlib")
                     or k.startswith("parallel_implementation_of_string_matching_algorithms_opencl_tpu."))
        assert not bad, bad
        print("ok", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        match(b"some text", b"text")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        base.resolve_device("cuda:0")
    with pytest.raises(ValueError):
        base.resolve_device("meta")
    assert match(b"some text", b"text", device="cpu").offsets_list() == [5]


def test_pattern_list_and_unported_algorithms_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        match(b"abc", [b"a", b"b"], device="cpu")
    for algo in ("naive", "kmp", "rabin_karp", "rk", "brute"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            match(b"abc", b"a", algo=algo, device="cpu")
    with pytest.raises(KeyError):
        match(b"abc", b"a", algo="nope", device="cpu")
    assert match(b"abcab", b"ab", algo="bm", device="cpu").count == 2
    assert port.available_algorithms() == ["boyer_moore"]
    with pytest.raises(ValueError):
        match(b"abc", b"", device="cpu")


@pytest.mark.parametrize("field,value", [
    ("bm_variant", "cursor"), ("bm_screen", "fused"), ("emission", "nib"),
    ("bm_probes", "table_dyn"), ("bm_probes", "table_gs1"),
])
def test_unported_modes_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MatchConfig(**{field: value})


@pytest.mark.parametrize("kw", [
    {"pad_multiple": 6}, {"pallas_chunk_bytes": 1000}, {"capacity": 0},
    {"bm_probes": "nope"}, {"emission": "dense"},
])
def test_bad_config_values_raise(kw):
    with pytest.raises(ValueError):
        MatchConfig(**kw)


def test_build_is_content_hashed_and_needs_nvcc(monkeypatch, tmp_path):
    """The library path is keyed by the source text; a missing nvcc raises
    (no fallback)."""
    path = cuda_build.library_path("swar")
    assert path.parent.parent == cuda_build.BUILD_DIR and path.name == "libswar.so"
    assert cuda_build.library_path("swar") == path
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
