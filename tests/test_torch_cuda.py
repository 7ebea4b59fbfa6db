"""PyTorch port on the card: the CUDA kernels against their plain versions
and ``match()`` against the oracle.  Every test here is marked ``cuda`` and
skips without a GPU.

This file imports neither jax nor the JAX package, so it also runs on a
machine without jax, where ``tests/conftest.py`` (which imports jax) must
be left out:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    reconstruct,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
    pad_to_multiple,
)

pytestmark = pytest.mark.cuda

TILE = 128 * 4096  # default-config tile
PATTERNS = [
    b"quick brown fox ",
    b"e",
    b"e ",
    b"\x00ab\x00",
    b"fox jumps over lazy dog and cat with so",
    bytes(range(1, 256)) + bytes(range(1, 255)),  # m = 509
]


@pytest.fixture
def cuda_device():
    """The card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _region(n: int, pat: bytes, device):
    data = bytearray(gen_english(n, seed=len(pat)))
    m = len(pat)
    for off in (0, 4093, TILE - m // 2, n // 2 + 1, n - m):
        data[off : off + m] = pat
    padded = pad_to_multiple(np.frombuffer(bytes(data), np.uint8), TILE)
    P, M = swar.pattern_words(np.frombuffer(pat, np.uint8))
    Nk, cut = swar.kernel_region(len(padded), m, 4096)
    words = torch.from_numpy(padded.view(np.int32).copy())[: Nk // 4]
    limit = min(n - m, cut - 1)
    return (words.to(device), limit, torch.from_numpy(P).to(device),
            torch.from_numpy(M).to(device))


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("n", [3 * TILE + 1234, 4 * TILE], ids=["n<Nk", "n=Nk"])
def test_kernels_bit_exact_against_plain(pat, n, cuda_device):
    """Both kernels equal their plain versions (tolerance 0), and each
    launch adds one to its counter."""
    words, limit, P, M = _region(n, pat, cuda_device)
    probes = swar.static_probes_from_table(
        swar.probe_table(np.frombuffer(pat, np.uint8), use_gs=True))
    k1, k2 = swar.screen_cand_bsums.launches, swar.naive_nib.launches
    bs = swar.screen_cand_bsums(words, limit, P, M, probes)
    nib, bs2 = swar.naive_nib(words, limit, P, M)
    torch.cuda.synchronize()
    assert (swar.screen_cand_bsums.launches, swar.naive_nib.launches) == (k1 + 1, k2 + 1)
    assert torch.equal(bs, swar.screen_cand_bsums_plain(words, limit, P, M, probes))
    nib_p, bs2_p = swar.naive_nib_plain(words, limit, P, M)
    assert torch.equal(nib, nib_p) and torch.equal(bs2, bs2_p)
    assert int(bs2.sum()) == len(find_all(
        words.cpu().numpy().tobytes()[: limit + len(pat)], pat))


def test_refused_launch_raises(cuda_device):
    """A launch the C entry refuses (word count not a multiple of 128)
    surfaces as an exception."""
    w = torch.zeros(256, dtype=torch.int32, device=cuda_device)
    P = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        swar._launch("tpm_naive_nib", w.device, w.data_ptr(), 100, 0,
                     P.data_ptr(), P.data_ptr(), 2, w.data_ptr(), w.data_ptr())


def test_match_end_to_end(cuda_device, monkeypatch):
    """match() on the card: exact against the oracle, through K1, and
    through K2 for the dense pattern (the gather width shrunk so a 4 MiB
    text can exceed it); drain complete."""
    monkeypatch.setattr(reconstruct, "SPARSE_CHUNKS_SMALL", 256)
    text = bytes(gen_english(4 << 20, seed=21))
    cfg = MatchConfig(capacity=4096)
    for pat, dense in ((b"quick brown fox ", False), (b"e ", True)):
        k1, k2 = swar.screen_cand_bsums.launches, swar.naive_nib.launches
        r = match(text, pat, config=cfg)
        want = find_all(text, pat)
        assert r.count == len(want) and r.offsets_list() == want[:4096]
        assert swar.screen_cand_bsums.launches == k1 + 1
        assert (swar.naive_nib.launches > k2) == dense
        r = match(text, pat, config=cfg, drain=True)
        assert r.offsets_list() == want
