"""PyTorch port: the decode, ``swar.decode_blocks``, from a scan's block
flags to every pattern's exact count and first offsets over [0, n - m].

On the CPU the wrapper runs its plain version (the blocks the kernel
verifies, gathered and compared byte for byte), held here against
``conformance/oracle.py``: the ``[k, width]`` layout, exact counts, the
ascending first ``capacity`` offsets and the overflow rule of
``reconstruct.extract_blocks``, on ragged lengths, a tail that holds valid
starts, stale bytes after n, a pattern ending in NUL bytes, pattern masks
for k = 1, 8 and 31, block sums for k = 40, m = 1 to 509, a text where
every block is flagged, and a block that holds a match with its flag
cleared, which the decode misses as the kernel does.  The kernel's rules
(which blocks a warp verifies for which pattern, its segments and its
screen words) are modelled in Python beside it.  The matchers' sparse
paths reach the wrapper on both devices.

The ``cuda`` cases hold the kernel against the plain version, count for
count and offset for offset, and check that the card's main paths launch
the decode and not the K2 rescan; they skip without a GPU.  This file
imports neither jax nor the JAX package, so on a machine without jax it
runs as

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_decode.py
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    RabinKarpMultiMatcher,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    rk_roll,
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    reconstruct,
    tables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
)

REGION = 32 * 4096  # the scanned region [0, Nk) of the hand-made cases

# name -> (k, m, pmask, geometry); geometry: "ragged" (n inside the
# region, the tail all padding, as the benchmark's corpora), "pad4096" (the
# text padded to 4096 only, so the tail holds valid starts), "halo" (stale
# bytes after n, as a stream chunk's buffer), "dense" (every block flagged),
# "cleared" (as "pad4096", with the last pattern's flag cleared in a block
# that holds its match: the decode misses those starts)
CASES = {
    "ragged-k1-m16": (1, 16, False, "ragged"),
    "pad4096-k1-m24": (1, 24, False, "pad4096"),
    "halo-k8-m16-pmask": (8, 16, True, "halo"),
    "nul-k1-m4": (1, 4, False, "nul"),
    "pad4096-k31-m16-pmask": (31, 16, True, "pad4096"),
    "halo-k40-m16": (40, 16, False, "halo"),
    "pad4096-k1-m1": (1, 1, False, "pad4096"),
    "pad4096-k2-m509-pmask": (2, 509, True, "pad4096"),
    "dense-k2-m2": (2, 2, False, "dense"),
    "dense-k8-m3-pmask": (8, 3, True, "dense"),
    "cleared-k1-m16": (1, 16, False, "cleared"),
    "cleared-k8-m16-pmask": (8, 16, True, "cleared"),
}
CAPACITIES = [0, 1, 4096]


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


def _case(name: str) -> dict:
    """A padded text (N bytes), its logical length n, k patterns of one
    length m, the region's cut and flags: block sums or pattern masks of
    the matches that start before the cut, with a few blocks flagged that
    hold none (a screen's false candidates)."""
    k, m, pmask, geo = CASES[name]
    rng = np.random.default_rng(len(name) * 1000 + k * 17 + m)
    N = REGION + 8192
    n = {"ragged": REGION - 3333, "pad4096": REGION + 5000, "cleared": REGION + 5000,
         "halo": REGION + 4700, "nul": REGION + 6000, "dense": N - 1000}[geo]
    if geo == "dense":
        data = bytearray(b"a" * N)
        pats = [bytes([97] * (m - 1) + [97 + (p % 3 == 2)]) for p in range(k)]
    else:
        data = bytearray(gen_english(N, seed=k * 31 + m))
        src = gen_english(1 << 16, seed=m + 5)
        pats = [src[997 * p + 13 : 997 * p + 13 + m] for p in range(k)]
        if geo == "nul":
            pats = [b"ab\x00\x00"]
        # Each pattern at block, chunk and cut seams, and at the last valid
        # start; the nibble of a NUL-ending pattern at n - 2 reads padding.
        cut = REGION - (m - 1)
        spots = [0, 509, 4093, REGION // 2 + 3, cut - 1, cut, cut + 7, n - m]
        for p, pat in enumerate(pats):
            for off in spots[p % 2 :: 1 + (p % 3)] + [int(rng.integers(0, n - m))]:
                if 0 <= off <= n - m:
                    data[off : off + m] = pat
        if geo == "nul":
            data[n - 2 : n] = b"ab"
    if geo in ("ragged", "nul", "pad4096", "cleared"):
        data[n:] = bytes(N - n)  # the zero padding
    elif geo == "halo":  # stale copies past n, one across it
        for off in (n - m + 1, n + 5, N - 3 * m):
            data[off : off + m] = pats[0]
    text = bytes(data)
    cut = REGION - (m - 1)
    limit = min(n - m, cut - 1)
    nb = REGION // 512
    flags = np.zeros(nb, np.int64)
    wants = [find_all(text[:n], pat) for pat in pats]
    for p, want in enumerate(wants):
        for s in want:
            if s <= limit:
                flags[s // 512] |= (1 << p) if pmask else 1
    false = rng.integers(0, nb, 5)
    flags[false] |= (1 << (k - 1)) if pmask else 3
    if geo == "dense":
        flags[:] = (1 << k) - 1 if pmask else 64
    if geo == "cleared":  # below the cut, so only its flag names the block
        b = next(s // 512 for s in wants[-1] if s // 512 * 512 + 511 < cut)
        flags[b] &= ~(1 << (k - 1)) if pmask else 0
        wants[-1] = [s for s in wants[-1] if s // 512 != b]
    return {"text": text, "n": n, "N": N, "pats": pats, "m": m, "k": k,
            "cut": cut, "pmask": pmask, "wants": wants,
            "flags": torch.from_numpy(flags.astype(np.int32))}


def _args(c: dict, device="cpu"):
    words = torch.from_numpy(_u8(c["text"]).copy()).view(torch.int32).to(device)
    Ps = torch.from_numpy(np.stack([swar.pattern_words(_u8(p))[0] for p in c["pats"]]))
    M = torch.from_numpy(swar.mask_words(c["m"]))
    return words, c["flags"].to(device), Ps.to(device), M.to(device)


def _selected(c: dict, b: int) -> int:
    """The kernel's rule (csrc/swar.cu ``block_patterns``): the patterns
    block b is verified for, as bits."""
    if 512 * b > c["n"] - c["m"]:
        return 0
    if 512 * b + 511 >= c["cut"]:
        return (1 << c["k"]) - 1
    f = int(c["flags"][b]) if b < c["flags"].numel() else 0
    return f if c["pmask"] else ((1 << c["k"]) - 1 if f else 0)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_decode_contract(name, capacity):
    """The plain version: counts int64[k] equal to the oracle's, offsets
    int64[k, width] whose first min(count, width) slots are the oracle's
    first starts and the rest -1, width = min(capacity, n - m + 1), where
    the oracle's starts in a block whose flag a case clears are left out,
    as the kernel leaves them; through
    ``extract_blocks`` the triples, overflow exactly when count > capacity.
    Under the kernel's rules every valid start lies in a block verified
    for its pattern, and the warp segments cover those blocks."""
    c = _case(name)
    words, flags, Ps, M = _args(c)
    n, m, cut = c["n"], c["m"], c["cut"]
    counts, offs = swar.decode_blocks(words, flags, Ps, M, cut, n, m, capacity, c["pmask"])
    width = min(capacity, n - m + 1)
    assert swar.decode_width(n, m, capacity) == width
    assert counts.dtype == offs.dtype == torch.int64
    assert tuple(counts.shape) == (c["k"],) and tuple(offs.shape) == (c["k"], width)
    for p, want in enumerate(c["wants"]):
        got = offs[p].tolist()
        assert int(counts[p]) == len(want), p
        assert got[: min(len(want), width)] == want[:width], p
        assert got[len(want) :] == [-1] * max(0, width - len(want)), p
    assert sum(map(len, c["wants"])) >= (300 if "dense" in name else c["k"])
    triples = reconstruct.extract_blocks(flags, words, Ps, M, cut, n, m, capacity,
                                         c["pmask"])
    for (count, o, over), want in zip(triples, c["wants"], strict=True):
        assert (count, o.tolist(), over) == (len(want), want[:capacity],
                                             len(want) > capacity)
    segs = swar.decode_segments(words.numel(), n - m)
    assert segs * swar.SEGMENT_BLOCKS * 512 > n - m >= (segs - 1) * swar.SEGMENT_BLOCKS * 512
    for p, want in enumerate(c["wants"]):
        assert all(_selected(c, s // 512) >> p & 1 for s in want)


def test_nul_ending_pattern_is_cleared_in_the_padding():
    """b"ab\\0\\0" at n - 2 would read the zero padding: no start past
    n - m counts, whatever the flags."""
    c = _case("nul-k1-m4")
    words, flags, Ps, M = _args(c)
    counts, offs = swar.decode_blocks(words, torch.ones_like(flags), Ps, M, c["cut"],
                                      c["n"], 4, 4096)
    assert c["text"][c["n"] - 2 : c["n"] + 2] == b"ab\x00\x00"
    assert int(counts[0]) == len(c["wants"][0]) and c["n"] - 2 not in offs[0].tolist()


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 7, 16, 24, 33, 100, 508, 509])
def test_decode_screen_words_are_stage_screens(m):
    """The kernel's screen words from m alone (``decode_screen``: per
    alignment the first and last whole words, word 0 twice if none is
    whole) equal those ``stage_screen`` picks from the masks, and lie in
    [0, nw)."""
    M = swar.mask_words(m)
    nw = M.shape[1]
    for a in range(4):
        full = np.nonzero(M[a] == -1)[0]
        want = (int(full[0]), int(full[-1])) if len(full) else (0, 0)
        first, last = (1 if a else 0), (a + m) // 4 - 1
        got = (first, last) if first <= last else (0, 0)
        assert got == want and 0 <= got[0] <= got[1] < nw == (m + 6) // 4


def test_decode_refuses_what_the_kernel_does_not_take():
    c = _case("ragged-k1-m16")
    words, flags, Ps, M = _args(c)
    args = (c["cut"], c["n"], 16, 64)
    with pytest.raises(ValueError, match="at most 32"):
        swar.decode_blocks(words, flags, Ps.repeat(33, 1, 1), M, *args, pmask=True)
    with pytest.raises(ValueError, match="needs"):
        swar.decode_blocks(words, flags, Ps, M, c["cut"], c["n"], 12, 64)
    with pytest.raises(ValueError, match="int32"):
        swar.decode_blocks(words, flags.to(torch.int64), Ps, M, *args)
    with pytest.raises(ValueError, match="4 KiB"):
        swar.decode_blocks(words[:-128], flags, Ps, M, *args)
    with pytest.raises(ValueError, match="block flags"):
        swar.decode_blocks(words[:1024], flags, Ps, M, *args)


class _Spy:
    """Counts the calls of ``swar.decode_blocks`` and their ``pmask``."""

    def __init__(self, monkeypatch):
        self.calls, self.fn = [], swar.decode_blocks
        monkeypatch.setattr(swar, "decode_blocks", self)

    def __call__(self, *args, **kw):
        self.calls.append(kw.get("pmask", args[8] if len(args) > 8 else False))
        return self.fn(*args, **kw)


ROUTE_TEXT = gen_english((2 << 20) + 4321, seed=5)
ROUTE_PATS = [b"the ", b"and ", b"fox ", b"zq\x00q"]  # the last absent


@pytest.mark.parametrize("algo", ["boyer_moore", "naive", "kmp", "rabin_karp"])
@pytest.mark.parametrize("emission", ["sparse", "nib"])
def test_match_sparse_path_takes_the_decode(algo, emission, monkeypatch):
    """A matcher's sparse path calls ``decode_blocks`` once (block sums),
    its ``nib`` path not at all; both exact."""
    spy = _Spy(monkeypatch)
    for pat in (b"quick brown fox ", ROUTE_TEXT[9000:9100]):
        r = match(ROUTE_TEXT, pat, algo=algo, config=MatchConfig(emission=emission),
                  device="cpu")
        want = find_all(ROUTE_TEXT, pat)
        assert (r.count, r.offsets_list()) == (len(want), want)
    assert spy.calls == ([False] * 2 if emission == "sparse" else [])


@pytest.mark.parametrize("gather", ["pselect", "blocks", "k40", "groups", "groups_width"])
def test_multi_run_takes_the_decode(gather, monkeypatch):
    """``RabinKarpMultiMatcher.run``: pselect decodes pattern masks, blocks
    and k > 31 block sums, groups its own gather, and past the group
    gather's width the decode of the blocks with a group."""
    spy = _Spy(monkeypatch)
    if gather == "groups_width":
        monkeypatch.setattr(reconstruct, "MULTI_BLOCK_TIER", 8)
    pats = ROUTE_PATS
    if gather == "k40":
        pats = [ROUTE_TEXT[5003 * i + 1 : 5003 * i + 17] for i in range(40)]
    cfg = MatchConfig(multi_gather={"k40": "pselect", "groups_width": "groups"}.get(
        gather, gather))
    mm = RabinKarpMultiMatcher(pats, cfg, device="cpu")
    for p, r in zip(pats, mm.match(ROUTE_TEXT), strict=True):
        want = find_all(ROUTE_TEXT, p)
        assert (r.count, r.offsets_list()) == (len(want), want)
    assert spy.calls == {"pselect": [True], "blocks": [False], "k40": [False],
                         "groups": [], "groups_width": [False]}[gather]


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _held(got, want, k: int) -> None:
    """The kernel's (counts, offsets) against the plain version's, count
    for count and offset for offset (the slots past a count are not
    defined on the card)."""
    (gc, go), (wc, wo) = got, want
    assert gc.device.type == "cuda" and gc.tolist() == wc.tolist()
    assert go.shape == wo.shape and go.shape[0] == k
    for p, c in enumerate(wc.tolist()):
        w = min(c, wo.shape[1])
        assert torch.equal(go[p, :w].cpu(), wo[p, :w]), p


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", CAPACITIES + [1 << 20])
@pytest.mark.parametrize("name", list(CASES))
def test_decode_kernel_equals_plain(name, capacity, cuda_device):
    """Every hand-made case on the card: counts and offsets equal to the
    plain version's and the oracle's, one launch a call."""
    c = _case(name)
    args = (c["cut"], c["n"], c["m"], capacity, c["pmask"])
    before = swar.decode_blocks.launches
    got = swar.decode_blocks(*_args(c, cuda_device), *args)
    torch.cuda.synchronize()
    assert swar.decode_blocks.launches == before + 1
    want = swar.decode_blocks_plain(*_args(c), *args)
    _held(got, want, c["k"])
    assert got[0].tolist() == [len(w) for w in c["wants"]]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k1-screen", "k8-pmask", "k40-bsums", "m509-pmask"])
def test_decode_kernel_on_scan_flags(mode, cuda_device):
    """The flags of the card's own scans on 4 MiB of English (K1 for one
    pattern, K6 masks, K5 sums), the text padded to 4096 only so the tail
    holds valid starts: the kernel equals the plain version and the
    oracle."""
    text = bytearray(gen_english((4 << 20) + 5555, seed=41))
    k, m = {"k1-screen": (1, 24), "k8-pmask": (8, 16), "k40-bsums": (40, 12),
            "m509-pmask": (3, 509)}[mode]
    pats = [bytes(text[7919 * i + 101 : 7919 * i + 101 + m]) for i in range(k)]
    n = len(text)
    for j, off in enumerate(((4 << 20) - m // 2, n - m, n - m - 1000)):
        text[off : off + m] = pats[j % k]
    text = bytes(text)
    N = -(-n // 4096) * 4096
    words = torch.zeros(N // 4, dtype=torch.int32)
    words.view(torch.uint8)[:n] = torch.from_numpy(_u8(text).copy())
    words = words.to(cuda_device)
    Ps = torch.from_numpy(np.stack([swar.pattern_words(_u8(p))[0] for p in pats]))
    Ps, M = Ps.to(cuda_device), torch.from_numpy(swar.mask_words(m)).to(cuda_device)
    tile = 128 * 16384
    Nk, cut = swar.tile_region(N, m, tile)
    limit = min(n - m, cut - 1)
    pmask = mode.endswith("pmask")
    if mode == "k1-screen":
        probes = swar.static_probes_from_table(swar.probe_table(_u8(pats[0]), use_gs=True))
        flags = swar.screen_cand_bsums(words[: Nk // 4], limit, Ps[0], M, probes)
    else:
        base = int(tables.RK_BASE)
        c = tables.rk_constants(m, base)
        tgt = torch.tensor([int(tables.rk_hash(_u8(p), c)) for p in pats],
                           device=cuda_device)
        scan = rk_roll.rk_candidate_pmask if pmask else rk_roll.rk_candidate_bsums
        flags = scan(words[: Nk // 4], limit, tgt, m, base)
    for capacity in (0, 5, 65536):
        got = swar.decode_blocks(words, flags, Ps, M, cut, n, m, capacity, pmask)
        want = swar.decode_blocks_plain(words.cpu(), flags.cpu(), Ps.cpu(), M.cpu(), cut,
                                        n, m, capacity, pmask)
        _held(got, want, k)
        assert got[0].tolist() == [len(find_all(text, p)) for p in pats]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["boyer_moore", "naive", "kmp", "rabin_karp",
                                   "multi-pselect", "multi-blocks", "multi-dense"])
def test_main_paths_launch_the_decode_not_k2(route, cuda_device):
    """``Matcher.run`` and ``RabinKarpMultiMatcher.run`` on the card: one
    decode launch a call and no K2 rescan (``naive_nib``), for a dense
    pattern too; exact against the oracle."""
    text = gen_english(4 << 20, seed=43)
    cfg = MatchConfig(capacity=4096)
    d, k2 = swar.decode_blocks.launches, swar.naive_nib.launches
    if route.startswith("multi"):
        pats = [b"e ", b" t", b"th"] if route == "multi-dense" else ROUTE_PATS
        gather = "blocks" if route == "multi-blocks" else "pselect"
        rs = RabinKarpMultiMatcher(pats, cfg.replace(multi_gather=gather),
                                   device=cuda_device).match(text)
        calls = 1
    else:
        pats = [b"quick brown fox ", b"e "]  # the second is dense
        rs = [match(text, p, algo=route, config=cfg) for p in pats]
        calls = len(pats)
    for p, r in zip(pats, rs, strict=True):
        want = find_all(text, p)
        assert (r.count, r.offsets_list(), r.overflow) == (
            len(want), want[:4096], len(want) > 4096), p
    assert swar.decode_blocks.launches == d + calls
    assert swar.naive_nib.launches == k2
