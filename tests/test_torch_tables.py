"""PyTorch port: host-side tables and per-pattern config against the JAX
package, bit for bit (numpy only; no kernel runs here)."""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.algorithms import (
    BoyerMooreMatcher as JaxBM,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    tables as jtables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    config as jconfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    io as jio,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    BoyerMooreMatcher,
    tables_from_reference,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    tables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
    io,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.config import (
    MatchConfig,
)


def _patterns():
    rng = np.random.default_rng(11)
    eng = jio.gen_english(4000, seed=3)
    pats = []
    for m in range(1, 41):  # every m in 1..40, drawn from English text
        s = int(rng.integers(0, len(eng) - m))
        pats.append(eng[s : s + m])
    pats += [
        b"\x00", b"ab\x00", b"\x00\x00\x00\x00\x00", b"\x00ab\x00cd\x00",
        b"abababababababab", b"aaaaaaaaaaaaaaaaaaaaa", b"abcabcabcabcabcabcab",
        "héllo wörld".encode(), "一é\U0001F680 match".encode(),
        bytes(range(256))[::7], bytes(rng.integers(0, 256, 509, np.uint8)),
    ]
    return pats


PATTERNS = _patterns()
IDS = [f"m{len(p)}-{i}" for i, p in enumerate(PATTERNS)]


def _u8(p: bytes) -> np.ndarray:
    return np.frombuffer(p, np.uint8)


@pytest.mark.parametrize("pat", PATTERNS, ids=IDS)
def test_swar_host_tables_bit_equal(pat):
    u = _u8(pat)
    P, M = swar.pattern_words(u)
    jP, jM = jswar.pattern_words(u)
    assert P.dtype == jP.dtype == np.int32
    assert np.array_equal(P, jP) and np.array_equal(M, jM)
    assert np.array_equal(swar.mask_words(len(pat)), jswar.mask_words(len(pat)))
    assert swar.probe_indices(M) == jswar._probe_indices(jM)
    for use_gs in (False, True):
        pr = swar.probe_table(u, use_gs=use_gs)
        jpr = jswar.probe_table(u, use_gs=use_gs)
        assert pr.dtype == jpr.dtype and np.array_equal(pr, jpr)
        assert (swar.static_probes_from_table(pr)
                == jswar.static_probes_from_table(jpr))


@pytest.mark.parametrize("pat", PATTERNS, ids=IDS)
def test_numpy_tables_bit_equal(pat):
    u = _u8(pat)
    for fn in ("bm_bad_char", "bm_good_suffix", "failure_function",
               "kmp_dfa"):
        got, want = getattr(tables, fn)(u), getattr(jtables, fn)(u)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn
    c, jc = tables.rk_constants(len(pat)), jtables.rk_constants(len(pat))
    assert all(np.array_equal(c[k], jc[k]) for k in jc)
    assert tables.rk_hash(u) == jtables.rk_hash(u)


@pytest.mark.parametrize("pat", PATTERNS, ids=IDS)
@pytest.mark.parametrize("probes", ["table_gs", "table", "static"])
def test_matcher_config_and_tables_equal_reference(pat, probes):
    """The port's _specialize_config stamps the same probe layout and its
    _precompute returns the same arrays as the JAX matcher."""
    pm = BoyerMooreMatcher(pat, MatchConfig(bm_probes=probes), device="cpu")
    jm = JaxBM(pat, jconfig.MatchConfig(bm_probes=probes))
    assert pm.config.bm_probe_layout == jm.config.bm_probe_layout
    assert pm.tables.keys() == jm.tables.keys()
    for k, v in jm.tables.items():
        assert pm.tables[k].dtype == v.dtype and np.array_equal(pm.tables[k], v), k
    want_probes = (jm.config.bm_probe_layout if probes != "static"
                   else jswar._probe_indices(jswar.mask_words(len(pat))))
    assert pm.dev_tables["probes"] == want_probes


@pytest.mark.parametrize("pat", PATTERNS[::5], ids=IDS[::5])
def test_tables_from_reference_round_trip(pat):
    jm = JaxBM(pat, jconfig.MatchConfig())
    dev = tables_from_reference(jm.tables, jm.config.bm_probe_layout, "cpu")
    assert dev["probes"] == jm.config.bm_probe_layout
    for k, v in jm.tables.items():
        t = dev[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), v) and t.numpy().dtype == v.dtype
    with pytest.raises(ValueError):
        tables_from_reference(jm.tables, ((0,),) * 3, "cpu")


@pytest.mark.parametrize("name", ["english", "dna", "binary", "utf8"])
def test_generators_byte_identical(name):
    assert io.GENERATORS[name](5000, seed=9) == jio.GENERATORS[name](5000, seed=9)
    arr = _u8(b"abcde")
    assert np.array_equal(io.pad_to_multiple(arr, 8),
                          jio.pad_to_multiple(arr, 8))
    assert np.array_equal(io.as_byte_array("héllo"), jio.as_byte_array("héllo"))
