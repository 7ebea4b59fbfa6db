"""Pattern-table precompute (host-side, numpy).

A numpy-only copy of the JAX package's ``ops/tables.py``: KMP failure
function and DFA, Boyer-Moore bad-character and good-suffix shift tables,
Rabin-Karp hash constants.  The tests hold every table bit-equal to the
reference's.  All tables are small (O(m) or O(m*256)).
"""

from __future__ import annotations

import numpy as np

ALPHABET = 256  # byte alphabet; Unicode-safe because we match raw UTF-8 bytes

# ---------------------------------------------------------------------------
# KMP: failure function and dense DFA
# ---------------------------------------------------------------------------


def failure_function(pattern: bytes | np.ndarray) -> np.ndarray:
    """Classic KMP prefix (failure) function.

    ``fail[j]`` = length of the longest proper prefix of ``pattern[:j+1]``
    that is also a suffix of it.  O(m).
    """
    pat = np.frombuffer(bytes(pattern), dtype=np.uint8) if isinstance(
        pattern, (bytes, bytearray)
    ) else np.asarray(pattern, dtype=np.uint8)
    m = len(pat)
    fail = np.zeros(m, dtype=np.int32)
    k = 0
    for j in range(1, m):
        while k > 0 and pat[j] != pat[k]:
            k = int(fail[k - 1])
        if pat[j] == pat[k]:
            k += 1
        fail[j] = k
    return fail


def kmp_dfa(pattern: bytes | np.ndarray) -> np.ndarray:
    """Densify the KMP automaton into a ``(m+1, 256)`` int32 table.

    ``dfa[s, b]`` is the next state after reading byte ``b`` in state ``s``
    (state = number of pattern bytes currently matched).  State ``m`` is the
    accepting state; transitions out of state ``m`` behave as if we had just
    followed the failure link (so overlapping occurrences are reported, which
    is the per-position-scan semantics all four algorithms share —
    BASELINE.json:5 requires byte-for-byte offset parity).

    This is the "branchless automaton step" table: on device the scan is
    simply ``state = dfa[state, byte]`` with no data-dependent control flow.
    """
    pat = np.frombuffer(bytes(pattern), dtype=np.uint8) if isinstance(
        pattern, (bytes, bytearray)
    ) else np.asarray(pattern, dtype=np.uint8)
    m = len(pat)
    if m == 0:
        raise ValueError("empty pattern")
    fail = failure_function(pat)
    dfa = np.zeros((m + 1, ALPHABET), dtype=np.int32)
    # State 0: everything stays at 0 except the first pattern byte.
    dfa[0, :] = 0
    dfa[0, pat[0]] = 1
    for s in range(1, m):
        # On mismatch behave like the failure state; on match advance.
        dfa[s, :] = dfa[fail[s - 1], :]
        dfa[s, pat[s]] = s + 1
    # Accepting state m: continue as from state fail[m-1] (including advancing
    # to fail[m-1]+1 on a match) — this yields overlapping-occurrence
    # semantics.
    dfa[m, :] = dfa[fail[m - 1], :]
    return dfa


# ---------------------------------------------------------------------------
# Boyer-Moore: bad-character and good-suffix tables
# ---------------------------------------------------------------------------


def bm_bad_char(pattern: bytes | np.ndarray) -> np.ndarray:
    """Bad-character table: ``last[b]`` = last index of byte ``b`` in the
    pattern, or -1 if absent.  int32[256].

    Shift on mismatch at pattern index ``j`` with text byte ``c`` is
    ``max(1, j - last[c])``.
    """
    pat = np.frombuffer(bytes(pattern), dtype=np.uint8) if isinstance(
        pattern, (bytes, bytearray)
    ) else np.asarray(pattern, dtype=np.uint8)
    last = np.full(ALPHABET, -1, dtype=np.int32)
    for j, b in enumerate(pat):
        last[int(b)] = j
    return last


def bm_good_suffix(pattern: bytes | np.ndarray) -> np.ndarray:
    """Good-suffix shift table, int32[m+1].

    ``good[j]`` is the shift to apply when a mismatch occurs at pattern index
    ``j-1`` (i.e. the suffix ``pattern[j:]`` matched).  ``good[0]`` is the
    shift after a full match.  Standard two-pass construction via the border
    array of the reversed pattern.
    """
    pat = np.frombuffer(bytes(pattern), dtype=np.uint8) if isinstance(
        pattern, (bytes, bytearray)
    ) else np.asarray(pattern, dtype=np.uint8)
    m = len(pat)
    good = np.zeros(m + 1, dtype=np.int32)
    border = np.zeros(m + 1, dtype=np.int32)

    # Case 1: the matching suffix occurs elsewhere in the pattern.
    i, j = m, m + 1
    border[i] = j
    while i > 0:
        while j <= m and pat[i - 1] != pat[j - 1]:
            if good[j] == 0:
                good[j] = j - i
            j = int(border[j])
        i -= 1
        j -= 1
        border[i] = j

    # Case 2: only a prefix of the pattern matches a suffix of the suffix.
    j = int(border[0])
    for i in range(m + 1):
        if good[i] == 0:
            good[i] = j
        if i == j:
            j = int(border[j])
    return good


# ---------------------------------------------------------------------------
# Rabin-Karp: wrapping-modulus polynomial hash constants
# ---------------------------------------------------------------------------

RK_BASE = np.uint32(0x01000193)  # FNV prime; odd => invertible mod 2**32


def _modinv_pow2_32(a: int) -> int:
    """Inverse of odd ``a`` modulo 2**32 via Newton iteration."""
    assert a & 1, "base must be odd to be invertible mod 2**32"
    x = a  # correct to 3 bits
    for _ in range(5):  # doubles correct bits each step: 3->6->12->24->48
        x = (x * (2 - a * x)) & 0xFFFFFFFF
    assert (a * x) & 0xFFFFFFFF == 1
    return x


def rk_constants(m: int, base: int | None = None) -> dict:
    """Rabin-Karp constants for window length ``m`` with modulus 2**32.

    The TPU-native design (SURVEY.md §7.3 stage 5, hard part #3) avoids
    64-bit ints and explicit ``%`` entirely: all arithmetic is uint32 and the
    modulus is 2**32, which int multiply/add wraparound implements for free.
    The base is odd, hence invertible mod 2**32, which enables the O(1)/byte
    prefix-difference rolling form.

    Returns dict with:
      base       uint32 scalar B
      base_inv   uint32 scalar B^-1 mod 2**32
      powers     uint32[m]  — B^(m-1-j) for j in [0, m): coefficient of
                 window byte j in the window hash
      high_pow   uint32 scalar B^(m-1)
    """
    b = int(base if base is not None else RK_BASE) & 0xFFFFFFFF
    if b % 2 == 0:
        raise ValueError("RK base must be odd (invertible mod 2**32)")
    binv = _modinv_pow2_32(b)
    powers = np.empty(m, dtype=np.uint32)
    acc = 1
    for j in range(m - 1, -1, -1):
        powers[j] = acc
        acc = (acc * b) & 0xFFFFFFFF
    return {
        "base": np.uint32(b),
        "base_inv": np.uint32(binv),
        "powers": powers,
        "high_pow": np.uint32(int(powers[0])),
    }


def rk_hash(data: bytes | np.ndarray, consts: dict | None = None) -> np.uint32:
    """Window hash of ``data`` under the wrapping polynomial scheme:
    ``H = sum(data[j] * B^(m-1-j)) mod 2**32``.  Host-side helper used to
    hash patterns and in unit tests."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.asarray(data, dtype=np.uint8)
    c = consts if consts is not None else rk_constants(len(arr))
    return np.uint32(
        (arr.astype(np.uint64) * c["powers"].astype(np.uint64)).sum() & 0xFFFFFFFF
    )
