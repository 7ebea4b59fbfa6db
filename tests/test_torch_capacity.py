"""PyTorch port: ``capacity=0`` is count-only, as in the reference.

With ``capacity=0`` every path returns the exact count, no offsets and
``overflow = count > 0``: each algorithm, a text with matches and one
without, pattern lists (each pattern on its own) under Rabin-Karp and
Boyer-Moore, ``RabinKarpMultiMatcher`` and every opt-in route, held against
``conformance/oracle.py`` and, where the JAX package runs the same call
(its plain jnp route, ``use_pallas="off"``), against its result.
``drain=True`` with ``capacity=0`` raises ValueError before any scan (the
reference recurses without end there). A 512-byte chunk makes every
kernel tile 64 KiB, so the texts cover several tiles and a tail.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    match as jmatch,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    config as jconfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import (
    MatchConfig,
    RabinKarpMultiMatcher,
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models import (
    base,
)

ALGOS = ["naive", "kmp", "rabin_karp", "boyer_moore"]
TILE = 128 * 512
PCFG = MatchConfig(pallas_chunk_bytes=512, capacity=0, pad_multiple=1024)
JCFG = jconfig.MatchConfig(use_pallas="off", pallas_chunk_bytes=512,
                           capacity=0, pad_multiple=1024)
PAT = b"quick brown fox "
ABSENT = b"zq\x00zq"


def _text(n: int = 3 * TILE + 777) -> bytes:
    """Seeded English with PAT planted across block, chunk and tile seams
    and at the last valid start (the tail)."""
    data = bytearray(gen_english(n, seed=11))
    for off in (0, 511, 4093, TILE - 5, 2 * TILE - 7, n - len(PAT)):
        data[off : off + len(PAT)] = PAT
    return bytes(data)


TEXT = _text()


def _count_only(r, want: list) -> None:
    assert (r.count, r.offsets_list(), r.overflow) == (len(want), [], len(want) > 0)
    assert r.offsets.dtype == np.int64


@pytest.mark.parametrize("pat", [PAT, ABSENT], ids=["matches", "none"])
@pytest.mark.parametrize("algo", ALGOS)
def test_count_only_equals_reference_and_oracle(algo, pat):
    want = find_all(TEXT, pat)
    assert (len(want) > 0) == (pat == PAT)
    r = match(TEXT, pat, algo=algo, config=PCFG, device="cpu")
    _count_only(r, want)
    j = jmatch(TEXT, pat, algo=algo, config=JCFG)
    assert (j.count, j.offsets_list(), j.overflow) == (r.count, [], r.overflow)


@pytest.mark.parametrize("algo", ["rabin_karp", "boyer_moore"])
def test_count_only_pattern_lists(algo):
    """Each pattern of a list is count-only on its own: equal lengths share
    one Rabin-Karp hash pass, the odd length out runs alone."""
    pats = [PAT, b"lazy dog and cat", ABSENT + b"zzzzzzzzzzz", b"the "]
    rs = match(TEXT, pats, algo=algo, config=PCFG, device="cpu")
    js = jmatch(TEXT, pats, algo=algo, config=JCFG)
    assert [r.pattern for r in rs] == pats
    for p, r, j in zip(pats, rs, js):
        _count_only(r, find_all(TEXT, p))
        assert (j.count, j.offsets_list(), j.overflow) == (r.count, [], r.overflow)
    if algo == "rabin_karp":
        assert [r.algo for r in rs].count("rabin_karp_multi") == 3


ROUTES = {
    "nib naive": ("naive", {"emission": "nib"}),
    "nib kmp": ("kmp", {"emission": "nib"}),
    "nib rabin_karp": ("rabin_karp", {"emission": "nib"}),
    "nib boyer_moore": ("boyer_moore", {"emission": "nib"}),
    "bm fused": ("boyer_moore", {"bm_screen": "fused"}),
    "bm table_dyn": ("boyer_moore", {"bm_probes": "table_dyn"}),
    "bm table_gs1": ("boyer_moore", {"bm_probes": "table_gs1"}),
    "bm cursor": ("boyer_moore", {"bm_variant": "cursor"}),
    "kmp ripple m=40": ("kmp", {"kmp_long": "ripple"}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_count_only_on_every_route(route):
    """The opt-in routes of tests/test_torch_opt_in.py: count-only
    against the oracle (KMP's ripple at m = 40, past one state word)."""
    algo, kw = ROUTES[route]
    pat = TEXT[4093 : 4093 + 40] if "ripple" in route else PAT
    want = find_all(TEXT, pat)
    assert want
    _count_only(match(TEXT, pat, algo=algo, config=PCFG.replace(**kw),
                      device="cpu"), want)


@pytest.mark.parametrize("gather", ["pselect", "blocks", "groups", "nib"])
def test_count_only_multi_matcher(gather):
    """``RabinKarpMultiMatcher`` under each extraction, on its own:
    count-only per pattern."""
    pats = [PAT, b"lazy dog and cat", b"search algorithm"]
    cfg = (PCFG.replace(emission="nib") if gather == "nib"
           else PCFG.replace(multi_gather=gather))
    rs = RabinKarpMultiMatcher(pats, cfg, device="cpu").match(TEXT)
    for p, r in zip(pats, rs):
        _count_only(r, find_all(TEXT, p))


def test_count_only_dense_rescan(monkeypatch):
    """A dense pattern, a match in nearly every block: the decode's plain
    version verifies the flagged blocks for the exact count and writes no
    offset (width 0), overflow set; no K2 rescan runs."""
    rescans, decodes = [], []

    def k2(*args, _k2=swar.naive_nib):
        rescans.append(args[1])
        return _k2(*args)

    def plain(*args, _plain=swar.decode_blocks_plain):
        counts, offsets = _plain(*args)
        decodes.append(tuple(offsets.shape))
        return counts, offsets

    monkeypatch.setattr(swar, "naive_nib", k2)
    monkeypatch.setattr(swar, "decode_blocks_plain", plain)
    want = find_all(TEXT, b"e ")
    assert len(want) > len(TEXT) // 512
    for algo in ("naive", "boyer_moore"):
        _count_only(match(TEXT, b"e ", algo=algo, config=PCFG, device="cpu"), want)
    assert decodes == [(1, 0), (1, 0)] and rescans == []


def test_drain_with_count_only_raises_before_any_scan(monkeypatch):
    """``drain=True, capacity=0`` raises ValueError, single pattern and
    list, before ``match`` scans anything."""
    def no_scan(*args, **kw):
        raise AssertionError("scanned")

    monkeypatch.setattr(base.Matcher, "match", no_scan)
    for pats in (PAT, [PAT, b"the "]):
        for algo in ALGOS:
            with pytest.raises(ValueError, match="capacity"):
                match(TEXT, pats, algo=algo, config=PCFG, drain=True,
                      device="cpu")


def test_negative_capacity_raises():
    with pytest.raises(ValueError, match="capacity"):
        MatchConfig(capacity=-1)
