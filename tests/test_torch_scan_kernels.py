"""PyTorch port: the plain versions of K3 (``swar.naive_bsums``), K4
(``shift_and.kmp_bsums``) and K5 (``rk_roll.rk_candidate_bsums``) against
the Pallas kernels they replace, run in interpret mode on the CPU.
Tolerance: exact integer equality.

The three reference kernels share one geometry at a 4096-byte chunk: a
512 KiB tile, 512-byte sub-chunks (the automaton and rolling-hash kernels'
independent scans) and 4 KiB chunks.  Matches are planted across those
seams, at the cut and at the last valid start, for n just below, at and
past the end of the kernel region Nk.  The Shift-AND kernel runs only at
K = 1 here (K > 1 costs minutes in interpret mode); K > 1 is held against
the oracle and the dense DFA in tests/test_torch_algorithms.py and against
its plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    rk_roll as jrk_roll,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    shift_and as jshift_and,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    tables as jtables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
    pad_to_multiple,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    rk_roll,
    shift_and,
    swar,
)

CHUNK = 4096
TILE = 128 * CHUNK  # 512 KiB
SUB = CHUNK // 8    # the reference's 512-byte sub-chunk
# n against the region end Nk = TILE (or 2 * TILE): the text is padded to
# the tile, except past Nk, where a 4 KiB pad leaves a short tail.
N_CASES = {
    "n=Nk-1": (TILE - 1, TILE),
    "n=Nk": (TILE, TILE),
    "n=Nk+3000": (TILE + 3000, 4096),
    "2tiles": (2 * TILE - 777, TILE),
}


@pytest.fixture(autouse=True)
def _small_kernel_floor(monkeypatch):
    monkeypatch.setattr(jswar, "MIN_KERNEL_BYTES", 0)


def _text(n: int, pad: int, pat: bytes, seed: int, extra=()) -> np.ndarray:
    """Seeded English of n bytes with ``pat`` planted across sub-chunk,
    chunk and tile seams, at the cut of the region and at the last valid
    start; ``extra`` plants (offset, bytes) pairs last."""
    data = bytearray(gen_english(n, seed=seed))
    m = len(pat)
    Nk = (-(-n // pad) * pad // TILE) * TILE
    offs = [0, SUB - 1, 3 * SUB - m // 2, CHUNK - 2, 7 * CHUNK + SUB - m + 1,
            TILE - m // 2, Nk - m, Nk - m + 1, n // 2 + 3, n - m]
    for off in offs:
        if 0 <= off <= n - m:
            data[off : off + m] = pat
    for off, b in extra:
        if 0 <= off <= n - len(b):
            data[off : off + len(b)] = b
    return pad_to_multiple(np.frombuffer(bytes(data), np.uint8), pad)


def _region(padded: np.ndarray, m: int):
    Nk, cut = shift_and.kernel_region(len(padded), m, CHUNK)
    words = torch.from_numpy(padded.view(np.int32).copy())[: Nk // 4]
    return words, Nk, cut


def _ref_args(padded: np.ndarray):
    return (jnp.asarray(padded),
            dict(chunk_bytes=CHUNK, interpret=True,
                 words=jnp.asarray(padded.view(np.int32).reshape(-1, 1024))))


@pytest.mark.parametrize("pat,case", [
    (b"the", "n=Nk-1"),
    (b"quick brown fox ", "n=Nk"),
    (b"ab\x00\x00", "n=Nk+3000"),
    (bytes(gen_english(300, seed=31)), "2tiles"),
], ids=lambda v: f"m{len(v)}" if isinstance(v, bytes) else v)
def test_naive_bsums_plain_matches_pallas(pat, case):
    n, pad = N_CASES[case]
    padded = _text(n, pad, pat, seed=len(pat))
    m = len(pat)
    words, Nk, cut = _region(padded, m)
    assert swar.kernel_region(len(padded), m, CHUNK) == (Nk, cut)
    P, M = swar.pattern_words(np.frombuffer(pat, np.uint8))
    t, kw = _ref_args(padded)
    nib_ref, bs_ref, cut_ref = jswar.naive_nib(
        t, n, jnp.asarray(P), m, emit_nib=False, **kw)
    assert nib_ref is None and cut == cut_ref
    bs = swar.naive_bsums(words, min(n, Nk) - m, torch.from_numpy(P),
                          torch.from_numpy(M))
    assert bs.dtype == torch.int32
    assert np.array_equal(bs.numpy(), np.asarray(bs_ref))
    assert int(bs.sum()) > 0


# (pattern length m, n case); m = 64 runs the screen: the one-word
# automaton of pattern[:32] with its own clamp min(n, Nk) - 32, and a
# prefix-only near-miss planted in (n - 64, n - 32] that it counts.
KMP_CASES = [(1, "n=Nk"), (4, "n=Nk-1"), (16, "n=Nk+3000"), (32, "2tiles"),
             (64, "n=Nk-1")]


@pytest.mark.parametrize("m,case", KMP_CASES, ids=[f"m{m}-{c}" for m, c in KMP_CASES])
def test_kmp_bsums_plain_matches_pallas(m, case):
    n, pad = N_CASES[case]
    pat = bytes(gen_english(m, seed=40 + m))
    mk = min(m, 32)
    extra = [(n - 40, pat[:32] + b"#" * 8)] if m > 32 else []
    padded = _text(n, pad, pat, seed=50 + m, extra=extra)
    words, Nk, cut = _region(padded, m)
    head = np.frombuffer(pat[:mk], np.uint8)
    t, kw = _ref_args(padded)
    bs_ref, cut_ref = jshift_and.kmp_bsums(
        t, n, jnp.asarray(jshift_and.b_table(head)), mk, **kw)
    assert cut_ref == Nk - (mk - 1)
    bt = torch.from_numpy(shift_and.b_table(head))
    bs = shift_and.kmp_bsums(words, min(n, Nk) - mk, bt, mk)
    assert bs.dtype == torch.int32
    assert np.array_equal(bs.numpy(), np.asarray(bs_ref))
    if m > 32:  # the screen counts the near-miss past n - m
        raw = padded[: min(n, Nk)].tobytes()
        assert raw[n - 40 : n - 8] == pat[:32]
        assert int(bs.sum()) >= raw.count(pat) + 1


RK_CASES = [(2, "n=Nk", None), (16, "n=Nk-1", None), (64, "n=Nk+3000", None),
            (509, "2tiles", None), (16, "n=Nk", 0x9E3779B1)]


@pytest.mark.parametrize("m,case,base", RK_CASES,
                         ids=[f"m{m}-{c}-{'base' if b else 'default'}"
                              for m, c, b in RK_CASES])
def test_rk_candidate_bsums_plain_matches_pallas(m, case, base):
    n, pad = N_CASES[case]
    pat = bytes(gen_english(m, seed=60 + m))
    padded = _text(n, pad, pat, seed=70 + m)
    words, Nk, cut = _region(padded, m)
    b = int(jtables.RK_BASE) if base is None else base
    h = jtables.rk_hash(np.frombuffer(pat, np.uint8),
                        jtables.rk_constants(m, b))
    t, kw = _ref_args(padded)
    bs_ref, cut_ref = jrk_roll.rk_candidate_bsums(
        t, n, np.asarray([h], np.uint32), m, b, **kw)
    assert cut == cut_ref
    bs = rk_roll.rk_candidate_bsums(words, min(n, Nk) - m,
                                    torch.tensor([int(h)]), m, b)
    assert bs.dtype == torch.int32
    assert np.array_equal(bs.numpy(), np.asarray(bs_ref))
    assert int(bs.sum()) > 0


def test_wrappers_reject_bad_inputs():
    w = torch.zeros(256, dtype=torch.int32)
    P = torch.from_numpy(swar.pattern_words(np.frombuffer(b"abcd", np.uint8))[0])
    M = torch.from_numpy(swar.mask_words(4))
    bt = torch.from_numpy(shift_and.b_table(np.frombuffer(b"abcd", np.uint8)))
    tgt = torch.tensor([123])
    with pytest.raises(TypeError):
        swar.naive_bsums(w.to(torch.int64), 0, P, M)
    with pytest.raises(ValueError):
        swar.naive_bsums(w[:200], 0, P, M)
    for bad_words in (w.to(torch.int64), w[:200], w.view(2, 128),
                      torch.zeros(512, dtype=torch.int32)[::2]):
        with pytest.raises((TypeError, ValueError)):
            shift_and.kmp_bsums(bad_words, 0, bt, 4)
        with pytest.raises((TypeError, ValueError)):
            rk_roll.rk_candidate_bsums(bad_words, 0, tgt, 4, 3)
    with pytest.raises(ValueError):  # K = 1 table for a K = 2 pattern
        shift_and.kmp_bsums(w, 0, bt, 40)
    with pytest.raises(ValueError):
        shift_and.kmp_bsums(w, 0, bt, 257)
    with pytest.raises(TypeError):
        shift_and.kmp_bsums(w, 0, bt.to(torch.int64), 4)
    with pytest.raises(TypeError):
        rk_roll.rk_candidate_bsums(w, 0, tgt.to(torch.int32), 4, 3)
    with pytest.raises(ValueError):
        rk_roll.rk_candidate_bsums(w, 0, tgt[:0], 4, 3)
    with pytest.raises(ValueError):
        rk_roll.rk_candidate_bsums(w, 0, tgt, 510, 3)
    with pytest.raises(ValueError):  # even base: not invertible mod 2**32
        rk_roll.rk_candidate_bsums(w, 0, tgt, 4, 2)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    pat = b"the"
    padded = _text(TILE, TILE, pat, seed=1)
    words, Nk, _ = _region(padded, 3)
    P, M = (torch.from_numpy(a) for a in swar.pattern_words(np.frombuffer(pat, np.uint8)))
    bt = torch.from_numpy(shift_and.b_table(np.frombuffer(pat, np.uint8)))
    h = torch.tensor([int(jtables.rk_hash(np.frombuffer(pat, np.uint8)))])
    before = (swar.naive_bsums.launches, shift_and.kmp_bsums.launches,
              rk_roll.rk_candidate_bsums.launches)
    lim = Nk - 3
    exact = swar.naive_bsums(words, lim, P, M)
    assert torch.equal(exact, swar.naive_bsums_plain(words, lim, P, M))
    assert torch.equal(exact, swar.naive_nib_plain(words, lim, P, M)[1])
    assert torch.equal(shift_and.kmp_bsums(words, lim, bt, 3), exact)
    assert torch.equal(shift_and.kmp_bsums_plain(words, lim, bt, 3), exact)
    rk = rk_roll.rk_candidate_bsums(words, lim, h, 3, int(jtables.RK_BASE))
    assert torch.equal(rk, rk_roll.rk_candidate_bsums_plain(
        words, lim, h, 3, int(jtables.RK_BASE)))
    assert bool((rk >= exact).all())
    assert (swar.naive_bsums.launches, shift_and.kmp_bsums.launches,
            rk_roll.rk_candidate_bsums.launches) == before
