"""PyTorch port: staging host bytes for ``match``, ``models/base.stage``.

On the CPU ``stage`` is ``pad_to_multiple`` and the array as a tensor.  On
a CUDA device it allocates the padded text on the card, zeroes only its
padding there, and copies the caller's unpadded bytes into it in one copy.
The CPU tests hold the CPU branch and ``match`` from host bytes at the pad's
edges; the tests marked ``cuda`` hold the card's branch against
``pad_to_multiple`` and the oracle, and skip without a GPU.
This file imports neither jax nor the JAX package, so it also runs where
``tests/conftest.py`` must be left out:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_staging.py
"""

import _torch_threads  # noqa: F401

import sys
import threading

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    RabinKarpMultiMatcher,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models import (
    base,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    BoyerMooreMatcher,
    RabinKarpMatcher,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_dna,
    gen_english,
    pad_to_multiple,
)

# A text of several MiB, so a copy spans many of the card's pages.
BIG = 4 << 20
LENGTHS = [0, 1, 4095, 4096, 4097, BIG - 1, BIG + 1, 3 * BIG + 17]
# The Boyer-Moore matcher's pad target: its kernel tile once the text
# fills one, whole 4096-byte rows below that.
BM_TILE = BoyerMooreMatcher._tile_bytes(MatchConfig())


def _bytes(n: int, seed: int) -> np.ndarray:
    """n seeded bytes, none of them zero, so a zero reads as padding."""
    return np.random.default_rng(seed).integers(1, 256, n, dtype=np.uint8)


# -- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("multiple", [4096, BM_TILE])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 3 * 4096 + 17])
def test_cpu_stage_equals_pad_to_multiple(n, multiple):
    """On the CPU ``stage`` gives ``pad_to_multiple``'s bytes, the text
    then zeros up to the next multiple (a whole one for an empty text)."""
    arr = _bytes(n, seed=n)
    text = base.stage(arr, multiple, torch.device("cpu"))
    want = pad_to_multiple(arr, multiple)
    assert text.device.type == "cpu" and text.dtype == torch.uint8
    assert text.numpy().tobytes() == want.tobytes()
    assert len(want) == -(-max(n, 1) // multiple) * multiple
    assert not want[n:].any()


ALGOS = ["boyer_moore", "naive", "kmp", "rabin_karp"]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("n", [4090, 4097])
def test_cpu_match_from_host_bytes_at_the_pad_edge(algo, n):
    """``match`` from host bytes on the CPU gives the oracle's answers for a
    pattern that ends the text, and finds no pattern that ends in NUL bytes
    in the zeroed padding behind it."""
    data = bytearray(gen_english(n, seed=n))
    data[-3:] = b"end"
    data[100:103] = b"end"
    data = bytes(data)
    assert find_all(data, b"end")[-1] == n - 3
    for p in (b"end", b"end\x00", b"nd\x00\x00"):
        r = match(data, p, algo=algo, device="cpu")
        want = find_all(data, p)
        assert (r.count, r.offsets_list()) == (len(want), want)


# -- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    """The first CUDA device; the test skips without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS + [10**8])
def test_card_stage_equals_pad_to_multiple(card, n):
    """The padded text on the card holds ``pad_to_multiple``'s bytes at
    the Boyer-Moore matcher's pad target."""
    arr = _bytes(n, seed=n + 1)
    mult = base.pad_target(n, MatchConfig(), BM_TILE)
    text = base.stage(arr, mult, card)
    assert text.device == card and text.dtype == torch.uint8
    got = text.cpu().numpy()
    want = pad_to_multiple(arr, mult)
    assert len(got) == len(want)
    assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 4095, BIG + 1])
def test_card_pad_reads_zero_in_a_dirty_block(card, n):
    """The padding reads zero when the caching allocator hands ``stage``
    a block that was filled with 0xFF and freed."""
    mult = base.pad_target(n, MatchConfig(), BM_TILE)
    size = -(-max(n, 1) // mult) * mult
    torch.cuda.synchronize(card)
    torch.cuda.empty_cache()
    dirty = torch.full((size,), 0xFF, dtype=torch.uint8, device=card)
    ptr = dirty.data_ptr()
    del dirty
    text = base.stage(_bytes(n, seed=3), mult, card)
    assert text.data_ptr() == ptr  # the dirty block came back
    assert not text[n:].any().item()


@pytest.mark.cuda
def test_card_stage_reads_the_callers_bytes_every_call(card):
    """Nothing is kept by the caller's buffer: two ``bytes`` objects of
    one length, and one ``bytearray`` changed between two calls, each
    give their own answers."""
    n = 2 * BIG + 17
    pat = b"TTTTACGTACGTTTTT"
    first, second = bytearray(gen_dna(n, seed=1)), bytearray(gen_dna(n, seed=2))
    for off in (5, BIG - 3, n - len(pat)):
        first[off : off + len(pat)] = pat
    second[BIG + 11 : BIG + 11 + len(pat)] = pat
    for data in (bytes(first), bytes(second)):
        assert match(data, pat, device=card).offsets_list() == find_all(data, pat)
    buf = bytearray(first)
    want = find_all(bytes(buf), pat)
    assert match(buf, pat, device=card).offsets_list() == want
    buf[5 : 5 + len(pat)] = b"A" * len(pat)
    buf[BIG + 100 : BIG + 100 + len(pat)] = pat
    want2 = find_all(bytes(buf), pat)
    assert want2 != want
    assert match(buf, pat, device=card).offsets_list() == want2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4090, BM_TILE + 7, BIG + 5])
def test_card_nul_ending_pattern_never_matches_the_padding(card, n):
    """A pattern that ends in NUL bytes, whose head ends the text, is not
    found in the zeroed padding, for one pattern and for a list."""
    data = bytearray(gen_english(n, seed=4))
    data[-3:] = b"end"
    data = bytes(data)
    pats = [b"end\x00", b"nd\x00\x00"]
    for p in pats:
        for algo in ("boyer_moore", "naive", "kmp", "rabin_karp"):
            r = match(data, p, algo=algo, device=card)
            assert (r.count, r.offsets_list()) == (0, [])
    for r in match(data, pats, algo="rabin_karp", device=card):
        assert (r.count, r.offsets_list()) == (0, [])


def _resident(m, data: bytes, pad: int) -> list:
    """[(count, offsets, overflow)] of ``m.run`` on ``data`` padded on the
    host and copied to the card in one pageable copy."""
    arr = np.frombuffer(data, np.uint8)
    text = base.to_device(pad_to_multiple(arr, pad), m.device)
    out = m.run(text, len(arr))
    if not isinstance(out, list):
        out = [out]
    return [(r.count, r.offsets_list(), r.overflow)
            for r in (base.make_result(m.name, b"", len(arr), *t) for t in out)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["boyer_moore", "rk_multi"])
def test_card_match_from_host_bytes_equals_run_on_a_resident_text(card, kind):
    """``match`` from host bytes gives ``run``'s answers on the same text
    padded on the host and held on the card, for Boyer-Moore and for a
    Rabin-Karp pattern list."""
    n = 3 * BIG + 17
    data = bytearray(gen_english(n, seed=6))
    for off in range(0, n - 16, n // 50):
        data[off : off + 16] = b"stage text probe"
    data = bytes(data)
    if kind == "boyer_moore":
        m = BoyerMooreMatcher(b"stage text probe", device=card)
        pad = m._pad_target(n)
        got = [m.match(data)]
    else:
        pats = [b"stage text probe", b"quick brown fox ", b"lazy dog and cat"]
        m = RabinKarpMultiMatcher(pats, device=card)
        pad = base.pad_target(n, m.config,
                              RabinKarpMatcher._tile_bytes(m.config))
        got = m.match(data)
    want = _resident(m, data, pad)
    assert [(r.count, r.offsets_list(), r.overflow) for r in got] == want
    assert want[0][0] >= 50


@pytest.mark.cuda
def test_card_two_threads_stage_at_once(card):
    """Two threads calling ``match`` on one device, each on its own text
    of several MiB, both get the oracle's answers on every call."""
    n = 2 * BIG + 999
    pat = b"two threads here"
    texts = []
    for t in range(2):
        data = bytearray(gen_english(n, seed=10 + t))
        for off in range(t * 1000 + 7, n - 16, n // (20 + 10 * t)):
            data[off : off + 16] = pat
        texts.append(bytes(data))
    wants = [find_all(d, pat) for d in texts]
    m = BoyerMooreMatcher(pat, device=card)
    m.match(texts[0])  # the kernels, built once
    errors = []

    def work(t: int) -> None:
        try:
            for _ in range(8):
                r = m.match(texts[t])
                if r.offsets_list() != wants[t] or r.count != len(wants[t]):
                    errors.append(f"thread {t}: count {r.count}")
        except Exception as e:  # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
