"""PyTorch port end to end: ``match(device="cpu")`` against the JAX
package's ``match`` (Pallas kernels in interpret mode) and the oracle.

Rule for the comparison with the reference: counts always equal; where the
reference reports ``overflow=False`` the offsets are equal, otherwise the
port's offsets are the ascending first ``capacity`` oracle offsets (which
the oracle check asserts in every case).
"""

import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    match as jmatch,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.algorithms import (
    BoyerMooreMatcher as JaxBM,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    reconstruct as jreconstruct,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    config as jconfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    BoyerMooreMatcher,
    tables_from_reference,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    reconstruct,
)

# Small chunks (64 KiB tiles) keep the interpret-mode reference fast; the
# same geometry puts the kernel/tail seam at the same byte in both.
TILE = 128 * 512
JCFG = jconfig.MatchConfig(use_pallas="on", interpret=True,
                           pallas_chunk_bytes=512, capacity=4096,
                           pad_multiple=1024)
PCFG = MatchConfig(pallas_chunk_bytes=512, capacity=4096, pad_multiple=1024)


@pytest.fixture(autouse=True)
def _small_kernel_floor(monkeypatch):
    monkeypatch.setattr(jswar, "MIN_KERNEL_BYTES", 0)


def check(text, pat: bytes, jax_ref: bool = True, cap: int = 4096, **kw):
    """Port vs oracle (and vs the JAX package); returns the port result."""
    raw = text.encode() if isinstance(text, str) else bytes(text)
    want = find_all(raw, pat)
    r = match(text, pat, config=PCFG.replace(capacity=cap), device="cpu", **kw)
    drained = kw.get("drain", False)
    assert r.count == len(want)
    assert r.overflow == (len(want) > cap and not drained)
    assert r.offsets_list() == (want if drained else want[:cap])
    if jax_ref:
        j = jmatch(text, pat, config=JCFG.replace(capacity=cap), **kw)
        assert j.count == r.count
        if not j.overflow:
            assert r.offsets_list() == j.offsets_list()
    return r


def _planted(n: int, pat: bytes, offsets, seed: int = 5) -> bytes:
    data = bytearray(gen_english(n, seed=seed))
    for off in offsets:
        if 0 <= off <= n - len(pat):
            data[off : off + len(pat)] = pat
    return bytes(data)


SEAM_PATTERNS = [b"quick brown fox ", b"q", b"e ",
                 b"fox jumps over lazy dog and cat with so"]


@pytest.mark.parametrize("pat", SEAM_PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("n", [3 * TILE + 777, 4 * TILE],
                         ids=["n<Nk", "n=Nk"])
def test_seams_chunk_tile_and_cut(pat, n):
    """Matches planted across 512-byte chunk, 4 KiB gather-row and 64 KiB
    tile seams, and at the last valid start (the cut seam when n = Nk)."""
    m = len(pat)
    offs = [0, 509, 4096 - 3, 2 * 4096 - m // 2, TILE - 5, 2 * TILE - m + 1,
            3 * TILE - 1 - m // 2, n - m]
    r = check(_planted(n, pat, offs), pat)
    assert n - m in r.offsets_list() or r.overflow


@pytest.mark.parametrize("pat", [b"ab\x00\x00", b"\x00\x00", b"b\x00"])
def test_nul_pattern_never_matches_padding(pat):
    n = 2 * TILE + 100
    data = bytearray(_planted(n, pat, [1000, TILE + 17]))
    data[-2:] = b"ab"  # "ab" + zero padding would match b"ab\0\0"
    r = check(bytes(data), pat)
    assert all(o <= n - len(pat) for o in r.offsets_list())


@pytest.mark.parametrize("m", [1, 509, 510])
def test_pattern_length_bounds(m):
    """m = 1, the kernel bound m = 509 and m = 510 (plain mask route); the
    long ones against the oracle only."""
    n = 2 * TILE + 300
    text = gen_english(n, seed=m)
    pat = text[1234 : 1234 + m]
    text = _planted(n, pat, [TILE - m // 2, n - m], seed=m)
    text = text[:1234] + pat + text[1234 + m :]
    check(text, pat, jax_ref=(m == 1))


def test_overlapping_aa():
    assert check(b"aaaa", b"aa").offsets_list() == [0, 1, 2]
    r = check(b"a" * (2 * TILE + 5), b"aa")
    assert r.count == 2 * TILE + 4 and r.overflow


def test_capacity_overflow_count_exact():
    r = check(b"a" * 500, b"aa", cap=16)
    assert r.count == 499 and r.overflow
    assert r.offsets_list() == list(range(16))


def test_str_input_gives_utf8_byte_offsets():
    text = "héllo wörld héllo 🚀 héllo"
    r = check(text, "héllo".encode())
    assert r.offsets_list() == find_all(text.encode(), "héllo".encode())
    assert match(text, "héllo", device="cpu").count == 3


def test_drain_returns_every_offset():
    text = gen_english(5 * TILE + 99, seed=8)
    r = check(text, b"e ", drain=True)
    assert r.count > 4096 and len(r.offsets) == r.count


@pytest.mark.parametrize("branch", ["small", "compact", "plain", "dense"])
def test_extract_region_selector_plants(branch, monkeypatch):
    """The four selector plants of the reference's tier test: a candidate
    chunk count above the gather width takes the K2 rescan in both
    packages; the others take the sparse gather."""
    monkeypatch.setattr(jreconstruct, "SMALL_G", 8)
    monkeypatch.setattr(jreconstruct, "SPARSE_CHUNKS_SMALL", 32)
    monkeypatch.setattr(reconstruct, "SPARSE_CHUNKS_SMALL", 32)
    calls = []
    k2 = swar.naive_nib

    def spy(*a, **kw):
        calls.append(a[0].numel())
        return k2(*a, **kw)

    monkeypatch.setattr(swar, "naive_nib", spy)
    pat = b"QZXWVKYJ"
    plants = {
        "small": [(c, 0) for c in range(5)],
        "compact": [(c, 0) for c in range(3, 23)],
        "plain": [(c, b) for c in range(10, 30) for b in range(8)],
        "dense": [(c, 0) for c in range(5, 45)],
    }[branch]
    text = _planted(64 * 4096, pat,
                    [c * 4096 + b * 512 + 17 + (c % 3) for c, b in plants],
                    seed=777)
    check(text, pat)
    assert bool(calls) == (branch == "dense"), calls


def test_port_runs_on_the_reference_matchers_tables():
    pat = b"brown fox jumps"
    text = _planted(3 * TILE + 5, pat, [77, TILE - 4, 2 * TILE + 1])
    jm = JaxBM(pat, JCFG)
    pm = BoyerMooreMatcher(pat, PCFG, device="cpu")
    pm.dev_tables = tables_from_reference(jm.tables, jm.config.bm_probe_layout,
                                          "cpu")
    r, j = pm.match(text), jm.match(text)
    assert (r.count, r.offsets_list()) == (j.count, j.offsets_list())
    assert r.offsets_list() == find_all(text, pat)


@pytest.mark.parametrize("probes", ["table", "static"])
def test_other_probe_selections(probes):
    pat = b"lazy dog and"
    text = _planted(2 * TILE + 31, pat, [4090, TILE - 3])
    r = match(text, pat, config=PCFG.replace(bm_probes=probes), device="cpu")
    assert r.offsets_list() == find_all(text, pat)
