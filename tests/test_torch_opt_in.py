"""PyTorch port: ``match(device="cpu")`` under the opt-in modes
``emission='nib'``, ``bm_screen='fused'``, ``bm_probes='table_dyn'`` and
``'table_gs1'``, against the oracle and the JAX package's ``match``; the
route each configuration takes; and the Boyer-Moore tables of those modes
against the JAX matcher's.

The JAX reference runs its plain jnp route (``use_pallas="off"``).  Rule:
counts always equal the oracle's and the reference's; offsets are the
oracle's first ``capacity``, and equal the reference's wherever it reports
``overflow=False``.  A 512-byte chunk makes every kernel tile 64 KiB, so
small texts cover several tiles.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

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
    rk_roll,
    shift_and,
    swar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.algorithms import (
    BoyerMooreMatcher,
    tables_from_reference,
)

ALGOS = ["naive", "kmp", "rabin_karp", "boyer_moore"]
TILE = 128 * 512
PCFG = MatchConfig(pallas_chunk_bytes=512, capacity=4096, pad_multiple=1024)
JCFG = jconfig.MatchConfig(use_pallas="off", pallas_chunk_bytes=512,
                           capacity=4096, pad_multiple=1024)
# The kernel wrappers a route may call (module, name).
WRAPPERS = [(swar, "screen_cand_bsums"), (swar, "naive_nib"),
            (swar, "naive_bsums"), (swar, "screened_nib"),
            (swar, "screened_bsums"), (shift_and, "kmp_bsums"),
            (shift_and, "kmp_nib"), (rk_roll, "rk_candidate_bsums"),
            (rk_roll, "rk_candidate_pmask"), (rk_roll, "rk_candidate_nib")]


@pytest.fixture
def calls(monkeypatch):
    """Records every kernel-wrapper call as (name, args): on the CPU the
    wrappers count no launches, so this is how a test sees the route."""
    log = []
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name):
            log.append((_name, args))
            return _fn(*args)

        monkeypatch.setattr(mod, name, spy)
    return log


def names(log) -> list:
    return [name for name, _ in log]


def check(text, pat, algo: str, cap: int = 4096, jax_ref: bool = True,
          pcfg=PCFG, jcfg=JCFG, **kw):
    """Port vs oracle (and vs the JAX package); returns the port result."""
    raw = text.encode() if isinstance(text, str) else bytes(text)
    want = find_all(raw, pat)
    r = match(text, pat, algo=algo, config=pcfg.replace(capacity=cap, **kw),
              device="cpu")
    assert r.count == len(want)
    assert r.overflow == (len(want) > cap)
    assert r.offsets_list() == want[:cap]
    if jax_ref:
        j = jmatch(text, pat, algo=algo, config=jcfg.replace(capacity=cap, **kw))
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


def _seam_text(n: int, pat: bytes, seed: int = 5) -> bytes:
    """Plants across 512-byte block, 4 KiB chunk and 64 KiB tile seams, at
    the region's cut and at the last valid start."""
    m = len(pat)
    return _planted(n, pat, [0, 511, 4096 - 3, 2 * 4096 - m // 2, TILE - 5,
                             2 * TILE - m + 1, 3 * TILE - m - 1,
                             3 * TILE - m, n - m], seed)


NIB_KERNEL = {"naive": "naive_nib", "kmp": "kmp_nib",
              "rabin_karp": "rk_candidate_nib", "boyer_moore": "screened_nib"}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("n", [3 * TILE - 1, 3 * TILE, 3 * TILE + 777],
                         ids=["n<Nk", "n=Nk", "n>Nk"])
def test_nib_emission_at_the_region_end(algo, n, calls):
    """Every algorithm under emission='nib', n just below, at and past the
    region end: exact, through its nibble kernel and no sparse one."""
    for pat in (b"quick brown fox ", b"e "):
        r = check(_seam_text(n, pat), pat, algo, emission="nib",
                  jax_ref=pat == b"e ")
        assert n - len(pat) in r.offsets_list() or r.overflow
    assert names(calls) == [NIB_KERNEL[algo]] * 2


BM_MODES = [(probes, screen, emission)
            for probes in ("table_gs", "table", "static", "table_dyn", "table_gs1")
            for screen in ("cand", "fused") for emission in ("sparse", "nib")]


@pytest.mark.parametrize("probes,screen,emission", BM_MODES,
                         ids=["-".join(c) for c in BM_MODES])
def test_boyer_moore_modes(probes, screen, emission, calls):
    """Boyer-Moore under every probe mode x screen x emission: exact; the
    route is K1 for sparse 'cand' (unless 'table_dyn'), K7/K8 without the
    plane for 'fused' or 'table_dyn', K7/K8 with it for 'nib', and the
    kernel gets the probes its mode selects."""
    pat = b"abracadabra quick"
    text = _seam_text(3 * TILE + 99, pat, seed=11)
    kw = dict(bm_probes=probes, bm_screen=screen, emission=emission)
    check(text, pat, "boyer_moore", jax_ref=probes in ("table_dyn", "table_gs1"),
          **kw)
    if emission == "nib":
        want = "screened_nib"
    elif screen == "fused" or probes == "table_dyn":
        want = "screened_bsums"
    else:
        want = "screen_cand_bsums"
    assert names(calls)[0] == want
    u = np.frombuffer(pat, np.uint8)
    layout = {
        "table_gs": swar.probe_table(u, use_gs=True),
        "table": swar.probe_table(u),
        "table_dyn": swar.probe_table(u),
        "table_gs1": swar.probe_table(u, use_gs=True, single=True),
    }.get(probes)
    layout = (swar.probe_indices(swar.mask_words(len(pat))) if layout is None
              else swar.static_probes_from_table(layout))
    assert calls[0][1][4] == layout
    if probes == "table_gs1":
        assert all(len(ks) == 1 for ks in layout)


@pytest.mark.parametrize("m", [33, 256, 300])
def test_kmp_nib_runs_the_whole_automaton(m, calls):
    """KMP under 'nib': the K-word automaton of the whole pattern for
    m <= 256 (never the pattern[:32] screen: a prefix-only near miss at the
    end must not count), the dense DFA above."""
    pat = bytes(gen_english(m, seed=300 + m))
    n = 3 * TILE + 500
    text = bytearray(_seam_text(n, pat, seed=12))
    text[TILE + 100 : TILE + 132] = pat[:32]  # prefix-only near misses
    text[n - 40 : n] = pat[:32] + b"#" * 8
    check(bytes(text), pat, "kmp", emission="nib", jax_ref=m == 33)
    if m <= 256:
        assert names(calls) == ["kmp_nib"]
        bt, mk = calls[0][1][2], calls[0][1][3]
        assert mk == m and tuple(bt.shape) == (shift_and.state_words(m), 256)
    else:
        assert calls == []


@pytest.mark.parametrize("m", [1, 509, 600])
def test_rk_nib_lengths_and_verify_capacity(m, calls):
    """Rabin-Karp under 'nib' at m = 1 (plain mask), 509 (K10b) and 600
    (plain mask), with verify_capacity below and above the candidates."""
    pat = bytes(gen_english(m, seed=400 + m))
    text = _seam_text(3 * TILE + 321, pat, seed=13)
    for vcap in (4, 1 << 17):
        check(text, pat, "rabin_karp", emission="nib", verify_capacity=vcap,
              jax_ref=vcap == 4)
    assert names(calls) == ["rk_candidate_nib"] * 2 * (m == 509)


def test_rk_nib_candidates_over_verify_capacity(calls):
    """More candidates than verify_capacity: the exact compare of the region
    clamped to its limit, counts and offsets exact, overflow by capacity."""
    text = _seam_text(3 * TILE + 5, b"e ", seed=14)
    want = find_all(text, b"e ")
    assert len(want) > 1000
    for cap in (100, 1 << 16):
        check(text, b"e ", "rabin_karp", cap=cap, emission="nib",
              verify_capacity=64)
    assert names(calls) == ["rk_candidate_nib"] * 2


@pytest.mark.parametrize("k", [8, 40])
def test_multi_nib(k, calls):
    """A pattern list under 'nib': one K10b plane over all k hashes, each
    pattern exact against the oracle (and the JAX multi matcher at k = 8;
    its k = 40 compile alone takes seconds)."""
    n = 3 * TILE + 2000
    base = gen_english(n, seed=15)
    pats = [base[4099 * i + 7 : 4099 * i + 23] for i in range(k - 2)]
    pats += [b"quick brown fox ", b"\x00never in text!\xfe"]
    text = _planted(n, pats[0], [TILE - 3, 3 * TILE - 16, n - 16], seed=15)
    cfg = PCFG.replace(emission="nib")
    rs = match(text, pats, algo="rabin_karp", config=cfg, device="cpu")
    js = jmatch(text, pats, algo="rabin_karp",
                config=JCFG.replace(emission="nib")) if k == 8 else rs
    for p, r, j in zip(pats, rs, js):
        want = find_all(text, p)
        assert r.algo == "rabin_karp_multi"
        assert r.count == len(want) == j.count and r.offsets_list() == want[:4096]
        if not j.overflow:
            assert r.offsets_list() == j.offsets_list()
    assert names(calls) == ["rk_candidate_nib"]
    assert calls[0][1][2].numel() == k


@pytest.mark.parametrize("algo", ALGOS)
def test_nib_dense_overflow_and_drain(algo):
    """A dense b"ab" text: counts exact past capacity with overflow set, the
    first capacity offsets equal the oracle's; drain returns them all."""
    text = b"ab" * (3 * TILE // 2) + b"a"
    for pat in (b"ab", b"abab"):
        check(text, pat, algo, cap=1000, emission="nib", jax_ref=False)
    r = match(text, b"abab", algo=algo, config=PCFG.replace(
        capacity=50000, emission="nib"), drain=True, device="cpu")
    assert not r.overflow and r.offsets_list() == find_all(text, b"abab")


def test_nul_pattern_never_matches_padding_under_nib():
    """A pattern ending in NUL bytes at the end of the text: the zero
    padding must not complete a match (the per-alignment validity)."""
    for algo in ALGOS:
        for pat in (b"ab\x00\x00", b"b\x00"):
            text = _planted(3 * TILE - 1, b"xyab", [3 * TILE - 5], seed=16)
            check(text, pat, algo, emission="nib", jax_ref=False)


@pytest.mark.parametrize("probes", ["table_dyn", "table_gs1"])
def test_bm_tables_equal_reference(probes):
    """The port's Boyer-Moore tables equal the JAX matcher's (``swar_pr``
    under 'table_dyn'), the stamped layout too, and the port runs exactly
    on the reference's tables carried across."""
    pat = b"abracadabra quick"
    jm = JaxBM(pat, jconfig.MatchConfig(bm_probes=probes))
    pm = BoyerMooreMatcher(pat, MatchConfig(bm_probes=probes), device="cpu")
    assert pm.tables.keys() == jm.tables.keys()
    assert ("swar_pr" in pm.tables) == (probes == "table_dyn")
    for k, v in jm.tables.items():
        assert pm.tables[k].dtype == v.dtype and np.array_equal(pm.tables[k], v), k
    assert pm.config.bm_probe_layout == jm.config.bm_probe_layout
    dev = tables_from_reference(jm.tables, pm._probe_layout(), "cpu")
    for k, t in dev.items():
        assert (t == pm.dev_tables[k]) if k == "probes" else torch.equal(t, pm.dev_tables[k]), k
    text = _seam_text(3 * TILE + 7, pat, seed=17)
    pm.dev_tables = dev
    r = pm.match(text)
    assert r.offsets_list() == find_all(text, pat)


def test_probe_table_single_equals_reference():
    """``probe_table(single=True)`` (and with good-suffix scores) equals the
    reference's for 200 seeded patterns, ties and repeated 4-grams
    included."""
    rng = np.random.default_rng(2024)
    for i in range(200):
        m = int(rng.integers(1, 80))
        alphabet = rng.integers(2, 256) if i % 3 else 3  # small: ties
        u = rng.integers(0, alphabet, m).astype(np.uint8)
        for gs in (False, True):
            got = swar.probe_table(u, use_gs=gs, single=True)
            want = jswar.probe_table(u, use_gs=gs, single=True)
            assert got.dtype == want.dtype and np.array_equal(got, want), (i, gs)
            assert (got[:, 0] == got[:, 1]).all()
