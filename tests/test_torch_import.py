"""PyTorch port: import isolation from JAX, the explicit device, the
algorithms, pattern lists, and the opt-in modes."""

import _torch_threads  # noqa: F401

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
    """Every module of the port (the command line, ``utils/profiling.py``
    and ``utils/native.py`` among them), imported in a fresh interpreter
    (the test process itself already holds jax, see conftest.py), leaves
    jax, the JAX package, the top-level ``exp/`` scripts and the root
    ``cli.py`` out of sys.modules."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import {port.__name__} as p
        names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert len(names) >= 31, names
        assert p.__name__ + ".exp.proto_kernels" in names, names
        for mod in ("streaming", "dist", "mesh", "multihost"):
            assert p.__name__ + ".parallel." + mod in names, names
        for mod in ("cli", "utils.profiling", "utils.native"):
            assert p.__name__ + "." + mod in names, names
        bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
                     or k.startswith("jaxlib")
                     or k.startswith("parallel_implementation_of_string_matching_algorithms_opencl_tpu.")
                     or k.split(".")[0] in ("exp", "screen_kernel_opt", "proto_kernels", "cli"))
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
    """A list of patterns runs (one result per pattern, in input order),
    with ``multi_gather='groups'`` too; all four algorithms and their
    aliases run; an unknown algorithm raises."""
    rs = match(b"abcab", [b"ab", "ca", b"b"], algo="rk", device="cpu")
    assert [r.offsets_list() for r in rs] == [[0, 3], [2], [1, 4]]
    assert [r.algo for r in rs] == ["rabin_karp_multi", "rabin_karp_multi",
                                    "rabin_karp"]
    rs = match(b"abc", [b"a", b"b"], algo="rk", device="cpu",
               multi_gather="groups")
    assert [r.offsets_list() for r in rs] == [[0], [1]]
    for algo in ("naive", "kmp", "rabin_karp", "rk", "brute", "bm",
                 "boyer_moore"):
        assert match(b"abcab", b"ab", algo=algo, device="cpu").offsets_list() == [0, 3]
    with pytest.raises(KeyError):
        match(b"abc", b"a", algo="nope", device="cpu")
    assert port.available_algorithms() == ["boyer_moore", "kmp", "naive",
                                           "rabin_karp"]
    with pytest.raises(ValueError):
        match(b"abc", b"", device="cpu")


@pytest.mark.parametrize("field,value", [
    ("bm_screen", "fused"), ("emission", "nib"),
    ("bm_probes", "table_dyn"), ("bm_probes", "table_gs1"),
    ("bm_variant", "cursor"), ("multi_gather", "groups"),
])
def test_ported_opt_in_modes_run(field, value):
    """The opt-in modes construct and match a short text on the CPU."""
    cfg = MatchConfig(**{field: value})
    assert getattr(cfg, field) == value
    r = match(b"abcab ab", b"ab", config=cfg, device="cpu")
    assert r.offsets_list() == [0, 3, 6] and r.count == 3


@pytest.mark.parametrize("kw", [
    {"pad_multiple": 6}, {"pallas_chunk_bytes": 1000}, {"capacity": -1},
    {"bm_probes": "nope"}, {"emission": "dense"},
    {"bm_variant": "skip"}, {"bm_chunk": 0}, {"dist_gather": "bogus"},
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
