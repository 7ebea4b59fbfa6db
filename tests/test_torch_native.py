"""PyTorch port: ``…_torch/utils/native.py``, its own binding to the repo's
native host library, against the JAX package's binding and the oracle on
the cases of ``tests/test_native.py``; and ``NativeFile.read_chunk`` into
a numpy array and into a ``torch.uint8`` tensor's numpy view.  The tests
skip only where the reference's do: the library cannot be built."""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import tables
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    native as ref_native,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    tables as port_tables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils import (
    native,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
)


@pytest.fixture
def lib():
    if native.load() is None:
        pytest.skip("native library unavailable")
    assert ref_native.available()
    return native


@pytest.mark.parametrize("algo", ["naive", "kmp", "boyer_moore", "rabin_karp", "bm",
                                  "rk"])
@pytest.mark.parametrize("pat", [b"t", b"the quick", b"aa", b"zzqx", b"\x00\x01"])
def test_serial_equals_the_reference_and_the_oracle(algo, pat, lib):
    text = gen_english(100_000, seed=13) + b"\x00\x01\x00\x01"
    cnt, offs = lib.serial_match(text, pat, algo=algo)
    ref_cnt, ref_offs = ref_native.serial_match(text, pat, algo=algo)
    expected = find_all(text, pat)
    assert cnt == ref_cnt == len(expected)
    assert offs.dtype == np.int64 and offs.tolist() == ref_offs.tolist() == expected


def test_serial_overlapping_and_capacity(lib):
    for algo in ("kmp", "boyer_moore", "naive", "rk"):
        cnt, offs = lib.serial_match(b"aaaa", b"aa", algo=algo)
        assert cnt == 3 and offs.tolist() == [0, 1, 2]
    cnt, offs = lib.serial_match(b"a" * 100, b"a", algo="naive", cap=7)
    assert (cnt, offs.tolist()) == (100, list(range(7)))
    assert ref_native.serial_match(b"a" * 100, b"a", cap=7)[1].tolist() == offs.tolist()
    with pytest.raises(KeyError):
        lib.serial_match(b"abc", b"a", algo="nope")


@pytest.mark.parametrize(
    "pat",
    [b"a", b"ab", b"aab", b"abcab", b"aabaabaa", b"abcdabce", bytes(range(100))],
)
def test_tables_equal_the_reference_and_numpy(pat, lib):
    arr = np.frombuffer(pat, np.uint8)
    pairs = [(lib.kmp_failure(arr), ref_native.kmp_failure(arr),
              tables.failure_function(arr), port_tables.failure_function(arr)),
             (lib.bm_bad_char(arr), ref_native.bm_bad_char(arr),
              tables.bm_bad_char(arr), port_tables.bm_bad_char(arr)),
             (lib.bm_good_suffix(arr), ref_native.bm_good_suffix(arr),
              tables.bm_good_suffix(arr), port_tables.bm_good_suffix(arr)),
             (lib.rk_powers(len(arr), tables.RK_BASE),
              ref_native.rk_powers(len(arr), tables.RK_BASE),
              tables.rk_constants(len(arr), None)["powers"],
              port_tables.rk_constants(len(arr), None)["powers"])]
    for mine, *others in pairs:
        for other in others:
            np.testing.assert_array_equal(mine, other)
        assert mine.dtype == others[0].dtype


def test_generators_equal_the_reference(lib):
    a = lib.gen_bytes(10_000, seed=7)
    np.testing.assert_array_equal(a, ref_native.gen_bytes(10_000, seed=7))
    np.testing.assert_array_equal(a, lib.gen_bytes(10_000, seed=7))
    assert not np.array_equal(a, lib.gen_bytes(10_000, seed=8))
    d = lib.gen_alphabet(50_000, b"ACGT", seed=3)
    np.testing.assert_array_equal(d, ref_native.gen_alphabet(50_000, b"ACGT", seed=3))
    assert set(np.unique(d)) <= set(b"ACGT")
    assert np.bincount(d, minlength=256)[list(b"ACGT")].min() > 10_000


def _numpy_out(n):
    return np.full(n, 0xFF, np.uint8)


def _tensor_out(n):
    # On the card the buffer would be pinned (pin_memory=True); its numpy
    # view is the same kind of array.
    return torch.full((n,), 0xFF, dtype=torch.uint8).numpy()


@pytest.mark.parametrize("make_out", [None, _numpy_out, _tensor_out],
                         ids=["new", "numpy", "torch"])
def test_native_file_reader(make_out, lib, tmp_path):
    data = lib.gen_bytes(300_000, seed=5).tobytes()
    p = tmp_path / "corpus.bin"
    p.write_bytes(data)
    with lib.NativeFile(str(p)) as f, ref_native.NativeFile(str(p)) as g:
        assert f.size == g.size == len(data)
        for offset, length, want_got in ((0, 100_000, 100_000),
                                         (250_000, 100_000, 50_000),  # crosses EOF
                                         (999_999, 10, 0)):  # past EOF
            out = None if make_out is None else make_out(length + 5)
            buf, got = f.read_chunk(offset, length, out)
            assert got == want_got and (out is None or buf is out)
            assert buf[:got].tobytes() == data[offset : offset + got]
            assert not buf[got:length].any()  # zero-padded past EOF
            if out is not None:
                assert (buf[length:] == 0xFF).all()  # nothing past length
            ref_buf, ref_got = g.read_chunk(offset, length)
            assert ref_got == got and ref_buf.tobytes() == buf[:length].tobytes()


def test_native_file_refuses_a_short_or_foreign_out(lib, tmp_path):
    p = tmp_path / "corpus.bin"
    p.write_bytes(b"abcdefgh")
    with lib.NativeFile(str(p)) as f:
        with pytest.raises(ValueError, match="holds"):
            f.read_chunk(0, 8, np.empty(4, np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            f.read_chunk(0, 8, np.empty(8, np.int32))
        with pytest.raises(ValueError, match="uint8"):
            f.read_chunk(0, 4, np.empty(16, np.uint8)[::2])
    with pytest.raises(OSError):
        lib.NativeFile(str(tmp_path / "missing.bin"))
