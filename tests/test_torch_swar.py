"""PyTorch port: the plain versions of K1 (``screen_cand_bsums``) and K2
(``naive_nib``) against the Pallas kernels they replace, run in interpret
mode on the CPU.  Tolerance: exact integer equality.

K1 is compared on texts with n <= Nk - 512: the Pallas screen's last chunk
reads a clamped (garbage) halo, so its block sums may differ in the
region's last 512-byte block when n comes within a few bytes of Nk.  K2 is
exact at every n.  The CUDA kernels themselves are held against the same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
    pad_to_multiple,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    swar,
)

CHUNK = 512              # reference SWAR chunk -> 64 KiB tiles
TILE = 128 * CHUNK

PATTERNS = [
    b"quick brown fox ",
    b"e",
    b"e ",
    b"the",
    b"\x00ab\x00",
    b"fox jumps over lazy dog and cat with so",
    b"string search algorithm parallel device memory vector lane tile "
    b"shard the quick brown fox jumps",
]


@pytest.fixture(autouse=True)
def _small_kernel_floor(monkeypatch):
    monkeypatch.setattr(jswar, "MIN_KERNEL_BYTES", 0)


def _text(n: int, pat: bytes, seed: int) -> np.ndarray:
    """Seeded English with ``pat`` planted across chunk and tile seams."""
    data = bytearray(gen_english(n, seed=seed))
    m = len(pat)
    for off in (0, CHUNK - 3, TILE - 5, 2 * TILE - m // 2, n // 2 + 1, n - m):
        if 0 <= off <= n - m:
            data[off : off + m] = pat
    return pad_to_multiple(np.frombuffer(bytes(data), np.uint8), TILE)


def _port_inputs(padded: np.ndarray, n: int, pat: bytes):
    P, M = swar.pattern_words(np.frombuffer(pat, np.uint8))
    Nk, cut = swar.kernel_region(len(padded), len(pat), CHUNK)
    words = torch.from_numpy(padded.view(np.int32).copy())[: Nk // 4]
    limit = min(n, Nk) - len(pat)
    return words, limit, torch.from_numpy(P), torch.from_numpy(M), Nk, cut


def _ref_call(fn, padded, n, pat, **kw):
    P, _ = jswar.pattern_words(np.frombuffer(pat, np.uint8))
    x2d = jnp.asarray(padded.view(np.int32).reshape(-1, 1024))
    return fn(jnp.asarray(padded), n, jnp.asarray(P), len(pat),
              chunk_bytes=CHUNK, interpret=True, words=x2d, **kw)


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("gs", [True, False], ids=["table_gs", "table"])
def test_screen_cand_plain_matches_pallas(pat, gs):
    n = 3 * TILE - 512 - 37   # n <= Nk - 512
    padded = _text(n, pat, seed=len(pat))
    words, limit, P, M, Nk, cut = _port_inputs(padded, n, pat)
    assert n <= Nk - 512
    probes = swar.static_probes_from_table(
        swar.probe_table(np.frombuffer(pat, np.uint8), use_gs=gs))
    _, bs_ref, cut_ref = _ref_call(
        jswar.screened_nib, padded, n, pat, static_probes=probes,
        emit_nib=False, screen_only=True)
    bs = swar.screen_cand_bsums(words, limit, P, M, probes)
    assert cut == cut_ref
    assert bs.dtype == torch.int32
    assert np.array_equal(bs.numpy(), np.asarray(bs_ref))
    assert np.array_equal(
        bs.numpy(), swar.screen_cand_bsums_plain(words, limit, P, M, probes).numpy())


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("tail", [-700, -1, 0, 3000],
                         ids=["n<Nk", "n=Nk-1", "n=Nk", "n>Nk"])
def test_naive_nib_plain_matches_pallas(pat, tail):
    n = 2 * TILE + tail       # any n: K2 clamps per alignment
    padded = _text(n, pat, seed=7 + len(pat))
    words, limit, P, M, Nk, cut = _port_inputs(padded, n, pat)
    nib_ref, bs_ref, cut_ref = _ref_call(jswar.naive_nib, padded, n, pat,
                                         emit_nib=True)
    nib, bs = swar.naive_nib(words, limit, P, M)
    assert cut == cut_ref
    assert nib.dtype == bs.dtype == torch.int32
    assert np.array_equal(nib.numpy(), np.asarray(nib_ref).reshape(-1))
    assert np.array_equal(bs.numpy(), np.asarray(bs_ref))


def test_wrappers_reject_bad_inputs():
    w = torch.zeros(256, dtype=torch.int32)
    P = torch.from_numpy(swar.pattern_words(np.frombuffer(b"abcd", np.uint8))[0])
    M = torch.from_numpy(swar.mask_words(4))
    probes = ((0,), (1,), (1,), (1,))
    with pytest.raises(TypeError):
        swar.screen_cand_bsums(w.to(torch.int64), 0, P, M, probes)
    with pytest.raises(ValueError):
        swar.screen_cand_bsums(w[:200], 0, P, M, probes)
    with pytest.raises(ValueError):
        swar.naive_nib(w.view(2, 128), 0, P, M)
    with pytest.raises(ValueError):
        swar.naive_nib(torch.zeros(512, dtype=torch.int32)[::2], 0, P, M)
    with pytest.raises(ValueError):
        swar.screen_cand_bsums(w, 0, P, M, ((0,), (1,), (1,), (9,)))
    with pytest.raises(ValueError):
        swar.naive_nib(w, 0, P[:, :1].contiguous(), M)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    padded = _text(TILE, b"the", seed=1)
    words, limit, P, M, _, _ = _port_inputs(padded, TILE, b"the")
    before = (swar.screen_cand_bsums.launches, swar.naive_nib.launches)
    probes = swar.probe_indices(M.numpy())
    assert torch.equal(swar.screen_cand_bsums(words, limit, P, M, probes),
                       swar.screen_cand_bsums_plain(words, limit, P, M, probes))
    got, want = swar.naive_nib(words, limit, P, M), swar.naive_nib_plain(words, limit, P, M)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (swar.screen_cand_bsums.launches, swar.naive_nib.launches) == before

