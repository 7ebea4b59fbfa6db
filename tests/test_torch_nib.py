"""PyTorch port: the plain versions of the ``emission='nib'`` and screened
Boyer-Moore kernels against the Pallas kernels they replace, run in
interpret mode on the CPU.  Tolerance: exact integer equality.

- K7 ``swar.screened_nib`` / ``screened_bsums`` against
  ``_screened_kernel`` (``static_probes``) and K8 against
  ``_screened_dyn_kernel`` (``probe_idx``), both ``emit_nib`` values;
- K10a ``shift_and.kmp_nib`` against the Shift-AND kernel with
  ``emit='nib'`` at K = 1, after the reference's downstream
  ``nibble_valid``; K > 1 (minutes in interpret mode) against
  ``naive_nib_plain`` and the oracle;
- K10b ``rk_roll.rk_candidate_nib`` against the rolling-hash kernel with
  ``emit='nib'`` for one and for eight targets, after ``nibble_valid``;
- ``emit.nibble_to_matches`` against the oracle and the reference's
  decoder.

The geometry is ``tests/test_torch_scan_kernels.py``'s: a 4096-byte chunk,
a 512 KiB tile and 512-byte sub-chunks, with matches planted across those
seams, at the cut and at the last valid start, for n just below, at and
past the end of the kernel region.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conformance.oracle import find_all
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
    emit as jemit,
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
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    emit,
    extract,
)

CHUNK = 4096
TILE = 128 * CHUNK  # 512 KiB
SUB = CHUNK // 8    # the reference's 512-byte sub-chunk
N_CASES = {
    "n=Nk-1": (TILE - 1, TILE),
    "n=Nk": (TILE, TILE),
    "n=Nk+3000": (TILE + 3000, 4096),
    "2tiles": (2 * TILE - 777, TILE),
}
BASE = int(jtables.RK_BASE)


@pytest.fixture(autouse=True)
def _small_kernel_floor(monkeypatch):
    monkeypatch.setattr(jswar, "MIN_KERNEL_BYTES", 0)


def _text(n: int, pad: int, pat: bytes, seed: int) -> np.ndarray:
    """Seeded English of n bytes with ``pat`` planted across sub-chunk,
    chunk and tile seams, at the cut and at the last valid start."""
    data = bytearray(gen_english(n, seed=seed))
    m = len(pat)
    Nk = (-(-n // pad) * pad // TILE) * TILE
    for off in (0, SUB - 1, 3 * SUB - m // 2, CHUNK - 2, 7 * CHUNK + SUB - m + 1,
                TILE - m // 2, Nk - m, Nk - m + 1, n // 2 + 3, n - m):
        if 0 <= off <= n - m:
            data[off : off + m] = pat
    return pad_to_multiple(np.frombuffer(bytes(data), np.uint8), pad)


def _setup(case: str, pat: bytes, seed: int):
    """(padded text, n, region words, Nk, cut, limit, reference args)."""
    n, pad = N_CASES[case]
    padded = _text(n, pad, pat, seed)
    m = len(pat)
    Nk, cut = shift_and.kernel_region(len(padded), m, CHUNK)
    words = torch.from_numpy(padded.view(np.int32).copy())[: Nk // 4]
    ref = (jnp.asarray(padded),
           dict(chunk_bytes=CHUNK, interpret=True,
                words=jnp.asarray(padded.view(np.int32).reshape(-1, 1024))))
    return padded, n, words, Nk, cut, min(n - m, cut - 1), ref


def _true_starts(padded: np.ndarray, pat: bytes, limit: int) -> list:
    return find_all(padded[: limit + len(pat)].tobytes(), pat)


# (pattern, n case); the last ends in NUL bytes and sits at the end of the
# text, where the zero padding would complete it.
SCREEN_CASES = [
    (b"e", "n=Nk-1"), (b"th", "n=Nk"), (b"quick", "n=Nk+3000"),
    (b"quick brown fox ", "2tiles"), (bytes(gen_english(64, seed=5)), "n=Nk"),
    (b"ab\x00\x00", "n=Nk+3000"),
]


@pytest.mark.parametrize("pat,case", SCREEN_CASES,
                         ids=[f"m{len(p)}-{c}" for p, c in SCREEN_CASES])
@pytest.mark.parametrize("probes", ["static", "dyn"])
def test_screened_plain_matches_pallas(pat, case, probes):
    """K7 (static probes) and K8 (runtime probe table) with and without the
    nibble plane equal the Pallas kernels and K2/K3's plain versions."""
    padded, n, words, Nk, cut, limit, (t, kw) = _setup(case, pat, len(pat))
    m = len(pat)
    u = np.frombuffer(pat, np.uint8)
    assert swar.kernel_region(len(padded), m, CHUNK) == (Nk, cut)
    P, M = swar.pattern_words(u)
    if probes == "static":
        table = swar.probe_table(u, use_gs=True)
        ref_kw = dict(static_probes=jswar.static_probes_from_table(table))
    else:
        table = swar.probe_table(u)
        ref_kw = dict(probe_idx=jswar.probe_table(u))
    layout = swar.static_probes_from_table(table)
    Pt, Mt = torch.from_numpy(P), torch.from_numpy(M)
    emit_nib = (probes == "static") == (m % 2 == 1)  # each mode, both emissions
    nib_ref, bs_ref, cut_ref = jswar.screened_nib(
        t, n, jnp.asarray(P), m, emit_nib=emit_nib, **ref_kw, **kw)
    assert cut_ref == cut
    nib, bs = swar.screened_nib(words, limit, Pt, Mt, layout)
    bsb = swar.screened_bsums(words, limit, Pt, Mt, layout)
    assert nib.dtype == bs.dtype == torch.int32
    assert np.array_equal(bs.numpy(), np.asarray(bs_ref))
    assert torch.equal(bsb, bs)
    if emit_nib:
        assert np.array_equal(nib.numpy(), np.asarray(nib_ref).reshape(-1))
    else:
        assert nib_ref is None
    nib2, bs2 = swar.naive_nib_plain(words, limit, Pt, Mt)
    assert torch.equal(nib, nib2) and torch.equal(bs, bs2)
    assert int(bs.sum()) == len(_true_starts(padded, pat, limit)) > 0


def test_screened_rejects_bad_probes():
    w = torch.zeros(256, dtype=torch.int32)
    P, M = (torch.from_numpy(a) for a in swar.pattern_words(np.frombuffer(b"abcdefgh", np.uint8)))
    for bad in (((0,),) * 3, ((0, 1, 2),) + ((0,),) * 3, ((9,),) * 4):
        with pytest.raises(ValueError, match="probe layout"):
            swar.screened_nib(w, 0, P, M, bad)
        with pytest.raises(ValueError, match="probe layout"):
            swar.screened_bsums(w, 0, P, M, bad)


KMP_CASES = [(1, "n=Nk"), (5, "n=Nk-1"), (16, "n=Nk+3000"), (32, "2tiles")]


@pytest.mark.parametrize("m,case", KMP_CASES, ids=[f"m{m}-{c}" for m, c in KMP_CASES])
def test_kmp_nib_plain_matches_pallas(m, case):
    """K10a at K = 1 equals the Pallas ``kmp_nib`` after ``nibble_valid``;
    its block sums are K4's and its plane K2's."""
    pat = bytes(gen_english(m, seed=80 + m))
    padded, n, words, Nk, cut, limit, (t, kw) = _setup(case, pat, 90 + m)
    u = np.frombuffer(pat, np.uint8)
    nib_ref, cut_ref = jshift_and.kmp_nib(
        t, n, jnp.asarray(jshift_and.b_table(u)), m, **kw)
    assert cut_ref == cut
    bt = torch.from_numpy(shift_and.b_table(u))
    nib, bs = shift_and.kmp_nib(words, limit, bt, m)
    want = np.asarray(jemit.nibble_valid(nib_ref, limit))
    assert np.array_equal(nib.numpy(), want)
    assert torch.equal(bs, shift_and.kmp_bsums_plain(words, limit, bt, m))
    P, M = (torch.from_numpy(a) for a in swar.pattern_words(u))
    assert torch.equal(nib, swar.naive_nib_plain(words, limit, P, M)[0])
    assert int(bs.sum()) == len(_true_starts(padded, pat, limit)) > 0


@pytest.mark.parametrize("m", [33, 100, 256])
def test_kmp_nib_multiword_plain(m):
    """K10a at K = 2..8 (no interpret run: minutes): the plane equals K2's
    and the oracle's starts, the block sums K4's."""
    pat = bytes(gen_english(m, seed=110 + m))
    padded, n, words, Nk, cut, limit, _ = _setup("2tiles", pat, 120 + m)
    u = np.frombuffer(pat, np.uint8)
    bt = torch.from_numpy(shift_and.b_table(u))
    nib, bs = shift_and.kmp_nib(words, limit, bt, m)
    P, M = (torch.from_numpy(a) for a in swar.pattern_words(u))
    assert torch.equal(nib, swar.naive_nib_plain(words, limit, P, M)[0])
    assert torch.equal(bs, shift_and.kmp_bsums_plain(words, limit, bt, m))
    pos = extract.nib_positions(nib.view(1, -1), torch.zeros(1, dtype=torch.int64))
    assert pos.tolist() == _true_starts(padded, pat, limit) != []


RK_CASES = [(1, 2, "n=Nk"), (1, 16, "n=Nk-1"), (1, 64, "n=Nk+3000"),
            (8, 16, "2tiles")]


@pytest.mark.parametrize("k,m,case", RK_CASES,
                         ids=[f"k{k}-m{m}-{c}" for k, m, c in RK_CASES])
def test_rk_candidate_nib_plain_matches_pallas(k, m, case):
    """K10b equals the Pallas ``rk_candidate_nib`` after ``nibble_valid``
    (its start nibbles are exact hash hits), its block sums K5's; every
    true start of each pattern is a candidate."""
    base_pat = bytes(gen_english(m, seed=130 + m))
    padded, n, words, Nk, cut, limit, (t, kw) = _setup(case, base_pat, 140 + m)
    pats = [base_pat] + [padded[9001 * i : 9001 * i + m].tobytes()
                         for i in range(1, k)]
    c = jtables.rk_constants(m, BASE)
    h = [int(jtables.rk_hash(np.frombuffer(p, np.uint8), c)) for p in pats]
    nib_ref, cut_ref = jrk_roll.rk_candidate_nib(
        t, n, np.asarray(h, np.uint32), m, BASE, **kw)
    assert cut_ref == cut
    tgt = torch.tensor(h)
    nib, bs = rk_roll.rk_candidate_nib(words, limit, tgt, m, BASE)
    assert np.array_equal(nib.numpy(),
                          np.asarray(jemit.nibble_valid(nib_ref, limit)))
    assert torch.equal(bs, rk_roll.rk_candidate_bsums_plain(words, limit, tgt, m, BASE))
    for p in pats:
        P, M = (torch.from_numpy(a) for a in swar.pattern_words(np.frombuffer(p, np.uint8)))
        exact = swar.naive_nib_plain(words, limit, P, M)[0]
        assert torch.equal(nib & exact, exact) and int(exact.ne(0).sum()) > 0


@pytest.mark.parametrize("capacity", [1, 7, 100, 1 << 20])
def test_nibble_to_matches_decodes_only_what_capacity_needs(capacity):
    """Count from the block sums; the first ``capacity`` offsets equal the
    oracle's and the reference decoder's, whatever blocks they fall in."""
    pat = b"th"
    padded, n, words, Nk, cut, limit, _ = _setup("n=Nk", pat, 3)
    P, M = (torch.from_numpy(a) for a in swar.pattern_words(np.frombuffer(pat, np.uint8)))
    nib, bs = swar.naive_nib_plain(words, limit, P, M)
    count, offs, over = emit.nibble_to_matches(nib, bs, capacity)
    want = _true_starts(padded, pat, limit)
    assert count == len(want) and over == (len(want) > capacity)
    assert offs.tolist() == want[:capacity]
    c_ref, o_ref, v_ref = jemit.nibble_to_matches(
        jnp.asarray(nib.numpy()), limit, min(capacity, 4096))
    o_ref = np.asarray(o_ref)
    assert int(c_ref) == count
    assert o_ref[o_ref >= 0].tolist() == want[: min(capacity, 4096)]
