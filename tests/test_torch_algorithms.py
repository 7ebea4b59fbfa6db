"""PyTorch port: ``match(device="cpu")`` for naive, KMP and Rabin-Karp
against the oracle and the JAX package's ``match``, their plain masks
(``ops/kmp``, ``ops/rabin_karp``) against the JAX functions, and the
matchers' tables against the JAX matchers'.

The JAX reference runs its plain jnp route (``use_pallas="off"``) for
speed, plus one case per algorithm with the Pallas kernels in interpret
mode at a 4096-byte chunk, where the port's kernels and the reference's
emit the same block sums.  Rule: counts always equal the oracle's and the
reference's; offsets are the oracle's first ``capacity``, and equal the
reference's wherever it reports ``overflow=False``.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    match as jmatch,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    shift_and as jshift_and,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.kernels import (
    swar as jswar,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.algorithms import (
    KMPMatcher as JaxKMP,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.algorithms import (
    NaiveMatcher as JaxNaive,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.algorithms import (
    RabinKarpMatcher as JaxRK,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    kmp as jkmp,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    rabin_karp as jrk,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    tables as jtables,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    config as jconfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_dna,
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
    KMPMatcher,
    NaiveMatcher,
    RabinKarpMatcher,
    tables_from_reference,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    kmp as kmp_ops,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    rabin_karp as rk_ops,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
    tables,
)

ALGOS = ["naive", "kmp", "rabin_karp"]
# 512-byte chunks: 64 KiB tiles for all three kernels, so small texts cover
# several tiles; the same geometry puts the seams at the same bytes in both
# packages.
TILE = 128 * 512
PCFG = MatchConfig(pallas_chunk_bytes=512, capacity=4096, pad_multiple=1024)
JCFG = jconfig.MatchConfig(use_pallas="off", pallas_chunk_bytes=512,
                           capacity=4096, pad_multiple=1024)
JMATCHERS = {"naive": JaxNaive, "kmp": JaxKMP, "rabin_karp": JaxRK}
PMATCHERS = {"naive": NaiveMatcher, "kmp": KMPMatcher,
             "rabin_karp": RabinKarpMatcher}


@pytest.fixture(autouse=True)
def _small_kernel_floor(monkeypatch):
    monkeypatch.setattr(jswar, "MIN_KERNEL_BYTES", 0)


def check(text, pat: bytes, algo: str, jcfg=JCFG, jax_ref: bool = True,
          cap: int = 4096, pcfg=PCFG, **kw):
    """Port vs oracle (and vs the JAX package); returns the port result."""
    raw = text.encode() if isinstance(text, str) else bytes(text)
    want = find_all(raw, pat)
    r = match(text, pat, algo=algo, config=pcfg.replace(capacity=cap),
              device="cpu", **kw)
    drained = kw.get("drain", False)
    assert r.count == len(want)
    assert r.overflow == (len(want) > cap and not drained)
    assert r.offsets_list() == (want if drained else want[:cap])
    if jax_ref:
        j = jmatch(text, pat, algo=algo, config=jcfg.replace(capacity=cap),
                   **kw)
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


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("pat", SEAM_PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("n", [3 * TILE + 777, 3 * TILE], ids=["n<Nk", "n=Nk"])
def test_seams(algo, pat, n):
    """Matches planted across 512-byte block, 4 KiB chunk and 64 KiB tile
    seams, and at the last valid start (the cut seam when n = Nk)."""
    m = len(pat)
    offs = [0, 511, 4096 - 3, 2 * 4096 - m // 2, TILE - 5, 2 * TILE - m + 1,
            3 * TILE - m - 1, n - m]
    r = check(_planted(n, pat, offs), pat, algo)
    assert n - m in r.offsets_list() or r.overflow


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("pat", [b"ab\x00\x00", b"\x00\x00", b"b\x00"])
def test_nul_pattern_never_matches_padding(algo, pat):
    n = 2 * TILE + 100
    data = bytearray(_planted(n, pat, [1000, TILE + 17]))
    data[-2:] = b"ab"  # "ab" + zero padding would match b"ab\0\0"
    r = check(bytes(data), pat, algo)
    assert all(o <= n - len(pat) for o in r.offsets_list())


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("m", [1, 32, 33, 256, 257, 509, 510])
def test_pattern_lengths(algo, m):
    """The kernel bounds: m = 1 (RK's mask route), 32/33 (one automaton
    word or two; the screen starts above 32), 256/257 (the ripple's bound),
    509/510 (every kernel's bound; 510 takes the plain masks).  KMP runs
    both ``kmp_long`` modes; the long patterns against the oracle only."""
    n = 2 * TILE + 300
    text = gen_english(n, seed=m)
    pat = text[1234 : 1234 + m]
    text = _planted(n, pat, [TILE - m // 2, n - m], seed=m)
    text = text[:1234] + pat + text[1234 + m :]
    modes = ("screen", "ripple") if algo == "kmp" else ("screen",)
    for mode in modes:
        check(text, pat, algo, jax_ref=m <= 33,
              pcfg=PCFG.replace(kmp_long=mode))


@pytest.mark.parametrize("m", [33, 64, 300, 509])
def test_kmp_screen_near_misses_at_the_end(m):
    """The screen kernel clamps at n - 32, so prefix-only near-misses that
    start in (n - m, n - 32] reach its block sums; the decode's limit
    n - m must drop them, for n below and at the region end."""
    pat = bytes(gen_english(m, seed=500 + m))
    near = pat[:32] + b"#" * 8
    for n in (3 * TILE - 4000, 3 * TILE):
        data = bytearray(_planted(n, pat, [4095, TILE - m // 2, n - m - 60]))
        data[n - 40 : n] = near
        text = bytes(data)
        padded = np.zeros(3 * TILE, np.uint8)
        padded[:n] = _u8(text)
        bt = KMPMatcher(pat, PCFG, device="cpu").dev_tables["sa_bt32"]
        screen = shift_and.kmp_bsums(torch.from_numpy(padded.view(np.int32)),
                                     n - 32, bt, 32)
        assert int(screen.sum()) >= len(find_all(text, pat)) + 1
        r = check(text, pat, "kmp", jax_ref=False)
        assert r.offsets_list() == find_all(text, pat)


def test_kmp_ripple_equals_screen_at_m64():
    pat = bytes(gen_english(64, seed=64))
    n = 3 * TILE - 55
    text = _planted(n, pat, [0, 4093, TILE - 30, 2 * TILE + 511, n - 64])
    s = check(text, pat, "kmp", jax_ref=False)
    r = check(text, pat, "kmp", jax_ref=False,
              pcfg=PCFG.replace(kmp_long="ripple"))
    assert (s.count, s.offsets_list()) == (r.count, r.offsets_list())
    assert s.count >= 5


@pytest.mark.parametrize("algo", ALGOS)
def test_overlap_overflow_and_drain(algo):
    assert check(b"aaaa", b"aa", algo).offsets_list() == [0, 1, 2]
    r = check(b"a" * 500, b"aa", algo, cap=16)
    assert r.count == 499 and r.overflow and r.offsets_list() == list(range(16))
    text = gen_english(5 * TILE + 99, seed=8)
    r = check(text, b"e ", algo, drain=True, jax_ref=False)
    assert r.count > 4096 and len(r.offsets) == r.count and not r.overflow


@pytest.mark.parametrize("algo", ALGOS)
def test_str_input_gives_utf8_byte_offsets(algo):
    text = "héllo wörld héllo 🚀 héllo"
    r = check(text, "héllo".encode(), algo)
    assert r.offsets_list() == find_all(text.encode(), "héllo".encode())
    assert match(text, "héllo", algo=algo, device="cpu").count == 3


@pytest.mark.parametrize("algo", ["naive", "brute", "kmp", "rabin_karp", "rk"])
def test_aliases_and_dna(algo):
    dna = gen_dna(3 * TILE + 5, seed=4)
    pat = dna[70000:70016]
    r = match(dna, pat, algo=algo, config=PCFG, device="cpu")
    assert r.offsets_list() == find_all(dna, pat)


# -- one case per algorithm with the Pallas kernels in interpret mode -------

INTERP_CHUNK = 4096


@pytest.mark.parametrize("algo", ALGOS)
def test_pallas_interpret_reference(algo):
    """At a 4096-byte chunk the reference runs the kernels the port
    replaces (K3, K4 at K = 1, K5) with sparse extraction."""
    tile = 128 * INTERP_CHUNK
    n = tile + 1000
    pat = b"lazy dog and cat"
    text = _planted(n, pat, [7, 4096 - 5, tile // 2 + 511, tile - 8, n - 16])
    jcfg = jconfig.MatchConfig(use_pallas="on", interpret=True,
                               pallas_chunk_bytes=INTERP_CHUNK,
                               capacity=4096, pad_multiple=4096)
    pcfg = MatchConfig(pallas_chunk_bytes=INTERP_CHUNK, capacity=4096)
    r = check(text, pat, algo, jcfg=jcfg, pcfg=pcfg)
    assert r.count >= 5


# -- the plain masks against the JAX functions -------------------------------


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


@pytest.mark.parametrize("m,chunk", [(1, 2048), (4, 64), (33, 100),
                                     (257, 2048), (300, 128)])
def test_kmp_start_mask_equals_reference(m, chunk):
    """Lane-parallel dense-DFA scan, several lanes or (m - 1 > chunk) one."""
    text = gen_english(9000, seed=m)
    pat = text[777 : 777 + m]
    text = text[: 9000 - m] + pat
    dfa = tables.kmp_dfa(_u8(pat))
    got = kmp_ops.kmp_start_mask(torch.from_numpy(_u8(text).copy()),
                                 torch.from_numpy(dfa), chunk)
    want = np.asarray(jkmp.kmp_start_mask(jnp.asarray(_u8(text)),
                                          jnp.asarray(dfa), chunk))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert np.flatnonzero(want).tolist() == find_all(text, pat)


def test_kmp_start_mask_short_text():
    dfa = torch.from_numpy(tables.kmp_dfa(_u8(b"abcdef")))
    out = kmp_ops.kmp_start_mask(torch.from_numpy(_u8(b"abc").copy()), dfa)
    assert out.shape == (3,) and not bool(out.any())


@pytest.mark.parametrize("m", [1, 2, 16, 64, 509])
@pytest.mark.parametrize("base", [None, 0x9E3779B1])
def test_rk_window_hashes_and_start_mask_equal_reference(m, base, monkeypatch):
    text = _u8(gen_english(6000, seed=m))
    pat = text[100 : 100 + m].copy()
    c = tables.rk_constants(m, base)
    powers = torch.from_numpy(c["powers"].astype(np.int64))
    t = torch.from_numpy(text.copy())
    h = rk_ops.rk_window_hashes(t, powers)
    jh = np.asarray(jrk.rk_window_hashes(jnp.asarray(text),
                                         jnp.asarray(c["powers"])))
    assert h.dtype == torch.int64 and np.array_equal(h.numpy(), jh)
    # The one-pass-per-byte form that large texts take gives the same.
    monkeypatch.setattr(rk_ops, "_UNFOLD_ELEMENTS", 0)
    assert torch.equal(rk_ops.rk_window_hashes(t, powers), h)
    monkeypatch.undo()
    ph = tables.rk_hash(pat, c)
    for vcap in (4, 131072):  # fewer candidates than the text, or the fallback
        got = rk_ops.rk_start_mask(t, torch.from_numpy(pat), powers, int(ph), vcap)
        want = np.asarray(jrk.rk_start_mask(
            jnp.asarray(text), jnp.asarray(pat), jnp.asarray(c["powers"]),
            jnp.uint32(ph), vcap))
        assert np.array_equal(got.numpy(), want)


def test_rk_hashes_pinned_to_rk_hash_for_every_kernel_length():
    """The wrap mod 2**32: for m = 2..509 and a non-default odd base, the
    port's window hashes equal ``rk_hash`` of each window."""
    text = _u8(gen_english(560, seed=2))
    t = torch.from_numpy(text.copy())
    for base in (None, 0xFFFFFFFF):
        for m in range(2, 510):
            c = tables.rk_constants(m, base)
            h = rk_ops.rk_window_hashes(t, torch.from_numpy(
                c["powers"].astype(np.int64)))
            for s in (0, 560 - m, 17 % (561 - m)):
                assert int(h[s]) == int(jtables.rk_hash(text[s : s + m], c)), (m, s)


@pytest.mark.parametrize("base", [None, 0x9E3779B1])
def test_rk_non_default_base_end_to_end(base):
    pat = b"quick brown fox "
    text = _planted(2 * TILE + 5, pat, [3, TILE - 7, 2 * TILE - 11])
    r = check(text, pat, "rabin_karp", pcfg=PCFG.replace(rk_base=base),
              jcfg=JCFG.replace(rk_base=base))
    assert r.count >= 3


@pytest.mark.parametrize("kw", [{"kmp_long": "fold"}, {"rk_base": 2},
                                {"rk_base": 1 << 32}, {"verify_capacity": 0},
                                {"kmp_chunk": 0}])
def test_bad_new_config_values_raise(kw):
    with pytest.raises(ValueError):
        MatchConfig(**kw)


# -- tables carried across ----------------------------------------------------

TABLE_PATTERNS = [b"e", b"quick brown fox ", bytes(gen_english(33, seed=1)),
                  bytes(gen_english(256, seed=2)), bytes(gen_english(300, seed=3)),
                  b"ab\x00\x00"]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("pat", TABLE_PATTERNS, ids=lambda p: f"m{len(p)}")
def test_tables_equal_reference_and_round_trip(algo, pat):
    """The port's _precompute returns the JAX matcher's arrays (its
    Shift-AND tables in the port's [K, 256] form), and
    ``tables_from_reference`` carries the JAX tables over unchanged."""
    cfg = dict(rk_base=0x9E3779B1) if algo == "rabin_karp" else {}
    jm = JMATCHERS[algo](pat, jconfig.MatchConfig(**cfg))
    pm = PMATCHERS[algo](pat, MatchConfig(**cfg), device="cpu")
    assert pm.tables.keys() == jm.tables.keys()
    dev = tables_from_reference(jm.tables, None, "cpu")
    assert "probes" not in dev
    for k, v in jm.tables.items():
        want = shift_and.b_table_from_halves(v) if k.startswith("sa_bt") else v
        got = pm.tables[k]
        assert np.array_equal(got, want) and got.dtype == np.asarray(want).dtype, k
        t = dev[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), want), k
        assert torch.equal(t, pm.dev_tables[k]), k


@pytest.mark.parametrize("algo", ALGOS)
def test_port_runs_on_the_reference_matchers_tables(algo):
    pat = b"brown fox jumps" + bytes(gen_english(30, seed=9))
    text = _planted(3 * TILE + 5, pat, [77, TILE - 4, 2 * TILE + 1])
    jm = JMATCHERS[algo](pat, JCFG)
    pm = PMATCHERS[algo](pat, PCFG, device="cpu")
    pm.dev_tables = tables_from_reference(jm.tables, None, "cpu")
    r, j = pm.match(text), jm.match(text)
    assert (r.count, r.offsets_list()) == (j.count, j.offsets_list())
    assert r.offsets_list() == find_all(text, pat)


def test_b_table_from_halves_and_pattern_recovery():
    for m in (1, 31, 32, 33, 200, 256):
        pat = _u8(bytes(gen_english(m, seed=m)))
        bt = shift_and.b_table(pat)
        assert bt.shape == (shift_and.state_words(m), 256) and bt.dtype == np.int32
        assert np.array_equal(shift_and.b_table_from_halves(jshift_and.b_table(pat)), bt)
        got = shift_and.pattern_from_table(torch.from_numpy(bt), m)
        assert got.numpy().tobytes() == pat.tobytes()
    assert rk_roll.rk_params(3, 7) == (7, 343)
    with pytest.raises(ValueError):
        rk_roll.rk_params(3, 8)
    assert swar.kernel_region(5 * TILE, 4, 512) == shift_and.kernel_region(
        5 * TILE, 4, 512)
    assert shift_and.kernel_region(3 << 21, 16, 16384) == (3 << 21, (3 << 21) - 15)
    assert swar.kernel_region(3 << 21, 16, 16384) == (3 << 21, (3 << 21) - 15)
    assert shift_and.kernel_region((1 << 21) - 4096, 16, 16384) == (0, 0)
