"""PyTorch port of the ``exp/`` kernel prototypes (K11a-d): the plain
versions against the Pallas kernels of ``exp/screen_kernel_opt.py`` and
``exp/proto_kernels.py``, run in interpret mode on the CPU, and the
screen -> group gather-verify -> offsets path against the oracle, and a
numpy model of K11d's gathered-tile verify (``gathered_verify``, following
``naive_groups_kernel`` in ``csrc/swar.cu``) against both.  Tolerance:
exact integer equality.

The ``exp/`` builders take no ``interpret`` flag, so ``pallas_call`` is
patched to ``functools.partial(pallas_call, interpret=True)`` for these
tests.  Importing an ``exp/`` module inserts the repo into ``sys.path`` and
points jax's persistent compilation cache at a directory of the repo; the
module fixture restores both straight after the import.

K11b (the lite screen, K1's function) is compared at n <= Nk - 512, as K1
is in ``tests/test_torch_swar.py``: the Pallas screen's last tile reads a
clamped (garbage) halo, which the per-word clamp lets through within a few
bytes of Nk.  K11a, K11c and K11d clamp per alignment and are exact at
every n.
"""

import _torch_threads  # noqa: F401

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.ops import (
    emit as jemit,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
    pad_to_multiple,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.exp import (
    proto_kernels,
    screen_kernel_opt,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
    swar,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 128 * 4096          # the prototypes' 512 KiB tile (R = 128)
GROUP = 4096               # bytes per gather-verify group
GROUP_WORDS = GROUP // 4
PATTERNS = [b"quick brown fox ", b"e ", b"fox jumps over lazy dog and cat with so"]


@pytest.fixture(scope="module")
def ref():
    """The two ``exp/`` modules, loaded from their files without entering
    ``sys.modules``; ``sys.path`` and jax's cache settings restored."""
    path = list(sys.path)
    cache_dir = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    mods = {}
    try:
        for name in ("screen_kernel_opt", "proto_kernels"):
            spec = importlib.util.spec_from_file_location(
                f"_exp_{name}", os.path.join(REPO, "exp", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    return mods


@pytest.fixture
def interp(ref, monkeypatch):
    """The ``exp/`` modules with every ``pallas_call`` in interpret mode
    and their builder caches cleared before and after."""
    builders = (ref["screen_kernel_opt"].build_variant,
                ref["proto_kernels"]._build_proto_screen,
                ref["proto_kernels"]._build_gv)
    for b in builders:
        b.cache_clear()
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield ref["screen_kernel_opt"], ref["proto_kernels"]
    for b in builders:
        b.cache_clear()


def _text(N: int, pat: bytes, seed: int):
    """(text bytes, padded uint8 array) of N bytes of seeded English with
    ``pat`` planted at the start, across block, group and tile seams, and
    at the end."""
    data = bytearray(gen_english(N, seed=seed))
    m = len(pat)
    for off in (0, 509, GROUP - 3, TILE - m // 2, TILE + GROUP - 1, N // 2 + 1,
                N - GROUP - 2, N - m):
        data[off : off + m] = pat
    text = bytes(data)
    return text, pad_to_multiple(np.frombuffer(text, np.uint8), TILE)


def _pattern(pat: bytes, gs: bool = True):
    u = np.frombuffer(pat, np.uint8)
    P, M = swar.pattern_words(u)
    probes = swar.static_probes_from_table(swar.probe_table(u, use_gs=gs))
    return P, M, probes


def _words(padded) -> torch.Tensor:
    return torch.from_numpy(padded.view(np.int32).copy())


@pytest.mark.parametrize("pat", PATTERNS, ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("tail", [-700, 0], ids=["n<Nk", "n=Nk"])
def test_v1_plain_matches_pallas(pat, tail, interp):
    """K11a: ``run_variant('v1')`` equals the Pallas ``_v1_kernel``."""
    sko, _ = interp
    text, padded = _text(2 * TILE, pat, seed=len(pat))
    n = 2 * TILE + tail
    P, M, probes = _pattern(pat)
    cnt_r, bs_r = sko.run_variant(
        "v1", jnp.asarray(padded), n, jnp.asarray(P), len(pat),
        jnp.asarray(padded.view(np.int32).reshape(-1, 1024)), probes)
    cnt, bs = screen_kernel_opt.run_variant("v1", _words(padded), n,
                                            torch.from_numpy(P), len(pat), probes)
    assert bs.dtype == cnt.dtype == torch.int32
    assert np.array_equal(bs.numpy(), np.asarray(bs_r))
    assert int(cnt) == int(np.asarray(cnt_r)[0, 0]) == int(bs.sum())
    # Every match is a candidate of its own alignment.
    nib, bs2 = swar.naive_nib_plain(_words(padded), n - len(pat),
                                    torch.from_numpy(P), torch.from_numpy(M))
    assert bool((bs2 <= bs).all()) and int(bs2.sum()) == len(find_all(text[:n], pat))


@pytest.mark.parametrize("R", [128, 256, 512])
def test_v2_matches_pallas_and_k1(R, interp):
    """K11b: ``run_variant('v2', R)`` equals the Pallas ``_v2_kernel`` on
    its Nk(R) region, and K1's plain version there."""
    sko, _ = interp
    pat = b"quick brown fox "
    N = 5 * TILE
    _, padded = _text(N, pat, seed=3)
    Nk = (N // (R * 4096)) * R * 4096
    n = Nk - 512 - 37
    P, M, probes = _pattern(pat)
    cnt_r, bs_r = sko.run_variant(
        "v2", jnp.asarray(padded), n, jnp.asarray(P), len(pat),
        jnp.asarray(padded.view(np.int32).reshape(-1, 1024)), probes, R)
    cnt, bs = screen_kernel_opt.run_variant("v2", _words(padded), n,
                                            torch.from_numpy(P), len(pat), probes, R)
    assert bs.numel() == Nk // 512
    assert np.array_equal(bs.numpy(), np.asarray(bs_r))
    assert int(cnt) == int(np.asarray(cnt_r)[0, 0])
    k1 = swar.screen_cand_bsums_plain(_words(padded)[: Nk // 4], n - len(pat),
                                      torch.from_numpy(P), torch.from_numpy(M), probes)
    assert torch.equal(bs, k1)


@pytest.mark.parametrize("pat", PATTERNS[:2], ids=lambda p: f"m{len(p)}")
@pytest.mark.parametrize("from_blocks", [False, True], ids=["words", "blocks"])
def test_proto_screen_matches_pallas(pat, from_blocks, interp):
    """K11c: ``proto_screen`` on the (L, 1024) and the (nb, 128) view
    equals the Pallas ``_proto_screen_kernel`` and K11a."""
    _, pk = interp
    _, padded = _text(2 * TILE, pat, seed=11)
    n = 2 * TILE - 3
    P, _, probes = _pattern(pat)
    width = 128 if from_blocks else 1024
    cnt_r, bs_r = pk.proto_screen(
        jnp.asarray(padded.view(np.int32).reshape(-1, width)), n, jnp.asarray(P),
        len(pat), probes, from_blocks=from_blocks)
    words = _words(padded)
    cnt, bs = proto_kernels.proto_screen(words.view(-1, width), n,
                                         torch.from_numpy(P), len(pat), probes,
                                         from_blocks=from_blocks)
    assert np.array_equal(bs.numpy(), np.asarray(bs_r))
    assert int(cnt) == int(np.asarray(cnt_r)[0, 0])
    cnt1, bs1 = screen_kernel_opt.run_variant("v1", words, n, torch.from_numpy(P),
                                              len(pat), probes)
    assert torch.equal(bs, bs1) and int(cnt) == int(cnt1)


@pytest.mark.parametrize("m", [2, 16, 40, 509])
def test_gather_verify_matches_pallas(m, interp):
    """K11d: ``gather_verify`` equals the Pallas ``_gv_kernel`` on (nib,
    cnt, bsr) for a list with the first and last group, the groups on both
    sides of a tile seam and fill ids; its rows equal K2's nibble plane on
    the listed groups."""
    _, pk = interp
    source = gen_english(8192, seed=5)
    pat = source[100 : 100 + m]
    text, padded = _text(2 * TILE, pat, seed=m)
    n = 2 * TILE - 5
    nb8 = padded.size // GROUP
    g8 = np.array([0, 3, TILE // GROUP - 1, TILE // GROUP, 200, nb8 - 1, nb8, nb8],
                  np.int32)
    cap_g = g8.size
    P, M, _ = _pattern(pat)
    blocks = padded.view(np.int32).reshape(-1, 128)
    nib_r, cnt_r, bsr_r = pk.gather_verify(jnp.asarray(blocks), jnp.asarray(g8),
                                           n - m, jnp.asarray(P), m, cap_g)
    words = _words(padded)
    nib, cnt, bsr = proto_kernels.gather_verify(
        words.view(-1, 128), torch.from_numpy(g8), n - m, torch.from_numpy(P), m, cap_g)
    assert nib.shape == (cap_g, 8, 128) and bsr.shape == (8 * cap_g,)
    assert np.array_equal(nib.numpy(), np.asarray(nib_r))
    assert np.array_equal(bsr.numpy(), np.asarray(bsr_r))
    assert int(cnt) == int(np.asarray(cnt_r)) == int(bsr.sum())
    k2, _ = swar.naive_nib_plain(words, n - m, torch.from_numpy(P), torch.from_numpy(M))
    rows = k2.view(-1, 8, 128)
    for i, g in enumerate(g8.tolist()):
        assert torch.equal(nib[i], rows[g] if g < nb8 else torch.zeros_like(nib[i]))
    want = [p for p in find_all(text[:n], pat) if p // GROUP in set(g8.tolist())]
    assert int(cnt) == len(want) > 0


def gathered_verify(words: np.ndarray, g8, n_lim: int, P: np.ndarray, M: np.ndarray):
    """(nib int64[G, 8, 128], bsr, total) as ``naive_groups_kernel`` in
    ``csrc/swar.cu`` computes K11d, stated in numpy.  Tile i is group g8[i]
    (1024 words) and the nw - 1 halo words after it, zeros past the text;
    an id outside [0, n_words / 1024) stages zeros and reads nothing.  Warp
    r verifies row r, block 8 g8[i] + r: K2's screen (each alignment's
    first and last whole words, word 0 twice if none is whole), the chains
    of the words with a hit only when the warp has one, the clamp of starts
    past n_lim, a row's 128 nibble words and its popcount; the total is
    the sum of the warps' rows."""
    words = np.asarray(words).view(np.uint32).astype(np.int64)
    P = np.asarray(P).view(np.uint32).astype(np.int64)
    M = np.asarray(M).view(np.uint32).astype(np.int64)
    nw = P.shape[1]
    n_groups = words.size // GROUP_WORDS
    whole = M == 0xFFFFFFFF
    ks = [(int(np.argmax(w)), int(w.size - 1 - np.argmax(w[::-1]))) if w.any() else (0, 0)
          for w in whole]
    nib = np.zeros((len(g8), 8, 128), np.int64)
    for i, g in enumerate(int(x) for x in g8):
        if not 0 <= g < n_groups:
            continue  # zero rows
        tile = np.zeros(GROUP_WORDS + nw - 1, np.int64)
        src = words[g * GROUP_WORDS:(g + 1) * GROUP_WORDS + nw - 1]
        tile[:src.size] = src
        for r in range(8):  # warp r
            win = np.lib.stride_tricks.sliding_window_view(
                tile[128 * r:128 * r + 128 + nw - 1], nw)  # [word j, k]
            hit = np.zeros(128, bool)
            for a, (k0, k1) in enumerate(ks):
                hit |= (((win[:, k0] & M[a, k0]) == P[a, k0])
                        & ((win[:, k1] & M[a, k1]) == P[a, k1]))
            if not hit.any():
                continue
            bits = np.zeros(128, np.int64)
            for a in range(4):
                ok = ((win & M[a]) == P[a]).all(1)
                bits |= (ok & hit).astype(np.int64) << a
            rel = np.clip(n_lim - 512 * (8 * g + r), -1, 512)
            keep = np.clip(rel - 4 * np.arange(128) + 1, 0, 4)
            nib[i, r] = bits & ((1 << keep) - 1)
    bsr = sum((nib >> a) & 1 for a in range(4)).sum(2).reshape(-1)
    return nib, bsr, int(bsr.sum())


@pytest.mark.parametrize("m", [2, 16, 40, 509])
def test_gathered_tiles_match_plain_and_pallas(m, interp):
    """K11d's gathered-tile verify, stated in numpy, equals
    ``gather_verify_plain`` on lists with the region's last group (its halo
    runs past the text), repeated ids, ids out of order, negative ids and
    fill ids, at a clamp mid-way into a listed group and at the last valid
    start; and the Pallas ``_gv_kernel`` on the lists without negative ids
    (it clamps a negative id's block index to group 0 and keeps its
    starts).  At m = 509 each group's 127-word halo reaches into the next
    group."""
    _, pk = interp
    pat = gen_english(8192, seed=6)[200:200 + m]
    text, padded = _text(TILE, pat, seed=m + 3)
    n = TILE - 7
    nb8 = padded.size // GROUP
    for g in (5, 70, nb8 - 1):  # the pattern across each group's last row and halo
        off = GROUP * (g + 1) - m // 2 - 1
        if off + m <= n:
            padded[off:off + m] = np.frombuffer(pat, np.uint8)
    words = padded.view(np.int32)
    P, M, _ = _pattern(pat)
    tw, tP, tM = torch.from_numpy(words.copy()), torch.from_numpy(P), torch.from_numpy(M)
    listed = [nb8 - 1, 5, 70, 70, 0, nb8, 3, nb8 - 1]
    for n_lim, ids in ((n - m, listed), (GROUP * 70 + 1500, listed + [-1, -9, nb8 + 4, 70])):
        nib, bsr, total = gathered_verify(words, ids, n_lim, P, M)
        want = swar.gather_verify_plain(tw, torch.tensor(ids, dtype=torch.int32), n_lim, tP, tM)
        assert np.array_equal(nib, want[0].numpy()) and np.array_equal(bsr, want[1].numpy())
        assert total == int(want[2]) > 0
    nib_r, cnt_r, bsr_r = pk.gather_verify(jnp.asarray(words.reshape(-1, 128)),
                                           jnp.asarray(np.array(listed, np.int32)),
                                           n - m, jnp.asarray(P), m, len(listed))
    nib, bsr, total = gathered_verify(words, listed, n - m, P, M)
    assert np.array_equal(nib, np.asarray(nib_r)) and np.array_equal(bsr, np.asarray(bsr_r))
    assert total == int(np.asarray(cnt_r))


def test_group_ids_match_masked_positions():
    """``group_ids`` equals the reference's ``emit.masked_positions`` of the
    occupied groups, fill nb // 8, at a cap below and above their count."""
    rng = np.random.default_rng(0)
    bs = (rng.random(4096) < 0.02).astype(np.int32) * rng.integers(1, 9, 4096)
    bs = bs.astype(np.int32)
    nb8 = bs.size // 8
    occupied = int((bs.reshape(-1, 8).sum(1) > 0).sum())
    for cap_g in (16, occupied, 4 * occupied):
        want = jemit.masked_positions(jnp.asarray(bs.reshape(-1, 8).sum(1) > 0),
                                      cap_g, fill=nb8)
        got = proto_kernels.group_ids(torch.from_numpy(bs), cap_g)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pat", [b"quick brown fox ", b"zebra", bytes(range(1, 200))],
                         ids=["m16", "m5", "m199"])
def test_gv_offsets_matches_oracle(pat):
    """The path: screen, group ids, gather-verify and decode give every
    match when the occupied groups fit in cap_g, and their first
    ``capacity`` offsets."""
    text, padded = _text(2 * TILE, pat, seed=len(pat) + 1)
    n = 2 * TILE - 1
    P, _, probes = _pattern(pat)
    want = find_all(text[:n], pat)
    assert want
    for capacity in (3, 1 << 16):
        count, offs, overflow = proto_kernels.gv_offsets(
            _words(padded), n, torch.from_numpy(P), len(pat), probes, 256, capacity)
        assert count == len(want) and overflow == (len(want) > capacity)
        assert offs.tolist() == want[:capacity]


def test_gv_offsets_past_cap_g_covers_the_listed_groups():
    """A dense pattern whose groups outnumber cap_g: the count and offsets
    are those of the first cap_g occupied groups, as in the reference."""
    text, padded = _text(TILE, b"e ", seed=9)
    n, cap_g = TILE, 16
    P, M, probes = _pattern(b"e ")
    words = _words(padded)
    count, offs, overflow = proto_kernels.gv_offsets(
        words, n, torch.from_numpy(P), 2, probes, cap_g, 1 << 16)
    _, bs = proto_kernels.proto_screen(words.view(-1, 1024), n, torch.from_numpy(P),
                                       2, probes)
    g8 = proto_kernels.group_ids(bs, cap_g)
    assert int((g8 < padded.size // GROUP).sum()) == cap_g
    _, k2_bs = swar.naive_nib_plain(words, n - 2, torch.from_numpy(P), torch.from_numpy(M))
    assert count == int(k2_bs.view(-1, 8).sum(1)[g8.long()].sum())
    listed = set(g8.tolist())
    want = [p for p in find_all(text, b"e ") if p // GROUP in listed]
    assert count == len(want) and offs.tolist() == want and not overflow


def test_wrappers_reject_bad_inputs():
    w = torch.zeros(2048, dtype=torch.int32)
    P, M, probes = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in _pattern(b"abcdefgh"))
    g8 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        swar.screen_cand_nibsums(w.to(torch.int64), 0, P, M, probes)
    with pytest.raises(ValueError):
        swar.screen_cand_nibsums(w, 0, P, M, ((0,), (1,), (1,), (9,)))
    with pytest.raises(ValueError):
        swar.gather_verify(w[:1536], g8, 0, P, M)
    with pytest.raises(ValueError):
        swar.gather_verify(w, g8.to(torch.int64), 0, P, M)
    with pytest.raises(ValueError):
        swar.gather_verify(w, g8.view(2, 2), 0, P, M)
    with pytest.raises(ValueError):
        screen_kernel_opt.run_variant("v3", w, 0, P, 8, probes)
    with pytest.raises(ValueError):
        proto_kernels.proto_screen(w.view(-1, 1024), 0, P, 8, probes)
    with pytest.raises(ValueError):
        proto_kernels.proto_screen(w.view(-1, 128), 0, P, 8, probes)
    with pytest.raises(ValueError):
        proto_kernels.gather_verify(w.view(-1, 128), g8, 0, P, 8, 8)
    with pytest.raises(ValueError):
        proto_kernels.group_ids(torch.zeros(12, dtype=torch.int32), 4)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    _, padded = _text(TILE, b"the ", seed=1)
    words = _words(padded)
    P, M, probes = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in _pattern(b"the "))
    g8 = torch.tensor([0, 5, 127, 128], dtype=torch.int32)
    before = (swar.screen_cand_nibsums.launches, swar.gather_verify.launches)
    got = swar.screen_cand_nibsums(words, TILE - 4, P, M, probes)
    want = swar.screen_cand_nibsums_plain(words, TILE - 4, P, M, probes)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = swar.gather_verify(words, g8, TILE - 4, P, M)
    want = swar.gather_verify_plain(words, g8, TILE - 4, P, M)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (swar.screen_cand_nibsums.launches, swar.gather_verify.launches) == before


def test_mains_run_on_the_cpu_when_asked_and_need_cuda_otherwise(monkeypatch, capsys):
    """Both entry points drive their checks on the CPU at 2 MiB, one tile
    of V4 (times "not measured"), and raise without CUDA when no device is
    given."""
    assert screen_kernel_opt.main(device="cpu", n=4 * TILE) == 0
    assert proto_kernels.main(device="cpu", n=4 * TILE) == 0
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "not measured" in out
    assert "offsets==oracle: True" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (screen_kernel_opt.main, proto_kernels.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main()
