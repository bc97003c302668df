"""The port's multi-pattern Shift-And against the JAX package.

``ShiftAndSet`` must equal the JAX one field by field (the same first-fit
placement, planes and masks); the port's plain count (the CPU path of
``shiftand_count``, and the comparison for the CUDA kernel in
``csrc/shiftand.cu``) must equal the JAX Pallas kernel in interpret mode,
brute force and the port's Aho-Corasick count. Counts are integers: every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from stringwars_tpu.ops import shiftand as JS
from stringwars_tpu_torch.ops import ahocorasick as A
from stringwars_tpu_torch.ops import shiftand as S
from stringwars_tpu_torch.ops import shiftand_cuda
from _torch_threads import one_thread  # noqa: F401


def brute_count(patterns, hay: bytes) -> int:
    total = 0
    for p in patterns:
        pos = hay.find(p)
        while pos >= 0:
            total += 1
            pos = hay.find(p, pos + 1)
    return total


SEVEN = [b"needle", b"haystack", b"pattern", b"search", b"string", b"find", b"match"]
SETS = {
    "four-words": [b"the", b"and", b"tion", b"abcd"],
    "one-byte": [b"a"],
    "pairs": [b"ab", b"ba", b"aa"],
    "nested": [b"abc", b"bc", b"c"],
    "html": [bytes([c]) for c in b"</>&'\"=[]"],
    "seven-words": SEVEN,
    "eight-words": SEVEN + [b"token"],
    "ties": [b"xy", b"ab", b"cd", b"q", b"ab", b"zzzzzzzzzzzzzzzzzzzzzzzzzzzzzz"],
    "zero-ff": [b"\x00a", b"\xff", b"a\x00\x00"],
}


def _planted(patterns, size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    text = bytearray(rng.integers(97, 123, size, dtype=np.uint8))
    for i in range(0, size - 64, 371):
        p = patterns[i % len(patterns)]
        text[i : i + len(p)] = p
    return bytes(text)


@pytest.mark.parametrize("name", sorted(SETS))
def test_shiftandset_matches_jax(name):
    patterns = SETS[name]
    want = JS.ShiftAndSet(patterns)
    got = S.ShiftAndSet(patterns)
    assert (got.n_words, got.max_len, got.start_mask, got.final_mask, got.occupied) == (
        want.n_words, want.max_len, want.start_mask, want.final_mask, want.occupied
    )
    assert got.planes.dtype == want.planes.dtype
    np.testing.assert_array_equal(got.planes, want.planes)


@pytest.mark.parametrize("name", sorted(SETS))
def test_byte_masks_select_the_pattern_chars(name):
    """mask(byte) bit p is set iff bit p is occupied and pattern char p is
    that byte; every occupied word starts with a start bit (what lets the
    kernel hold two words in one u64)."""
    sa = S.ShiftAndSet(SETS[name])
    chars = {}
    for k in range(8):
        for p in range(64):
            if (int(sa.planes[p // 32, k]) if p // 32 < sa.n_words else 0) >> (p % 32) & 1:
                chars[p] = chars.get(p, 0) | (1 << k)
    for b in range(256):
        want = sum(1 << p for p in range(64) if sa.occupied >> p & 1 and chars.get(p, 0) == b)
        assert int(sa.byte_masks[b]) == want, b
    for w in range(sa.n_words):
        assert sa.start_mask >> (32 * w) & 1


@pytest.mark.parametrize(
    "patterns,message",
    [
        ([], "need at least one pattern"),
        ([b"a", b""], "empty patterns not allowed"),
        ([b"x" * 33], "longer than"),
        ([bytes([97 + i]) * 22 for i in range(3)], "exceeds"),
        ([b"x" * 20, b"y" * 20, b"z" * 20], "do not pack"),
    ],
)
def test_guards_match_jax(patterns, message):
    with pytest.raises(ValueError) as want:
        JS.ShiftAndSet(patterns)
    with pytest.raises(ValueError, match=message) as got:
        S.ShiftAndSet(patterns)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["four-words", "nested", "seven-words", "zero-ff"])
def test_plain_count_matches_pallas_brute_and_ac(name):
    patterns = SETS[name]
    hay = np.frombuffer(_planted(patterns, 12_000, seed=len(name)), np.uint8)
    want = brute_count(patterns, hay.tobytes())
    assert want > 0
    sa = S.ShiftAndSet(patterns)
    got = S.shiftand_count(sa, torch.from_numpy(hay.copy()))
    assert got == want == JS.shiftand_count(JS.ShiftAndSet(patterns), hay, interpret=True)
    assert got == A.ac_count(A.Automaton(patterns), torch.from_numpy(hay.copy()))


@pytest.mark.parametrize("name", sorted(SETS))
def test_plain_count_matches_brute_and_ac(name):
    patterns = SETS[name]
    hay = _planted(patterns, 6_000, seed=3)
    hay_t = torch.frombuffer(bytearray(hay), dtype=torch.uint8)
    want = brute_count(patterns, hay)
    assert S.shiftand_count(S.ShiftAndSet(patterns), hay_t) == want == A.ac_count(A.Automaton(patterns), hay_t)


@pytest.mark.parametrize("chunk", [1, 4, 5, 256, 4096])
def test_seams(chunk):
    """Matches straddling chunk seams count once (tests/test_shiftand.py's case)."""
    hay = np.frombuffer(b"needle" * 3000, np.uint8)
    sa = S.ShiftAndSet([b"needle", b"dle"])
    assert S.shiftand_count_plain(sa, torch.from_numpy(hay.copy()), chunk=chunk).item() == 3000 * 2
    if chunk == 4096:
        assert JS.shiftand_count(JS.ShiftAndSet([b"needle", b"dle"]), hay, interpret=True) == 6000


@pytest.mark.parametrize("k", range(1, 16))
def test_unaligned_views_match_jax(k):
    """A view ``hay[k:]`` (not 16-byte aligned: the CUDA wrapper copies it
    once) counts as the JAX function counts the same bytes."""
    patterns = SETS["four-words"]
    hay = np.frombuffer(_planted(patterns, 4_200, seed=k), np.uint8)
    n = 4_099
    view = torch.from_numpy(hay.copy())[k:]
    want = JS.shiftand_count(JS.ShiftAndSet(patterns), hay[k : k + n])
    assert want == brute_count(patterns, hay[k : k + n].tobytes()) > 0
    assert S.shiftand_count(S.ShiftAndSet(patterns), view, n) == want


def test_two_words_match_jax():
    """tests/test_shiftand.py's seven-word set: two state words."""
    sa = S.ShiftAndSet(SEVEN)
    assert sa.n_words == 2 and sum(map(len, SEVEN)) > 32
    text = bytearray(np.random.default_rng(0).integers(97, 123, 20_000, dtype=np.uint8))
    for i in range(0, 19_000, 371):
        p = SEVEN[i % len(SEVEN)]
        text[i : i + len(p)] = p
    hay = np.frombuffer(bytes(text), np.uint8)
    want = brute_count(SEVEN, bytes(text))
    assert S.shiftand_count(sa, torch.from_numpy(hay.copy())) == want
    assert JS.shiftand_count(JS.ShiftAndSet(SEVEN), hay, interpret=True) == want


# Sets at the state words' edges: a word filled to bit 31, both filled to
# bit 63, a 32-char pattern, one-byte patterns (start bits equal final
# bits: the find suite's charsets).
FULL_SETS = {
    "bit 31": [b"ab" * 16],
    "bits 31 and 63": [b"ab" * 16, b"ba" * 16],
    "bits 31 and 63, many": [b"abc" * 7 + b"ab" * 5 + b"a", b"b" * 16, b"ca" * 8],
    "one-byte": [bytes([c]) for c in b"\n\r\x0b\x0cab"],
}


@pytest.mark.parametrize("name", sorted(FULL_SETS))
def test_full_words_match_jax(name):
    """The kernel's recurrence (two independent 32-bit words, as the plain
    version runs it) counts as the JAX kernel counts, with patterns ending
    at the haystack's last byte, at n below one chunk and past it."""
    patterns = FULL_SETS[name]
    sa = S.ShiftAndSet(patterns)
    top = max(p for p in range(64) if sa.occupied >> p & 1)
    assert top in (31, 63) or name == "one-byte"
    assert sa.start_mask == sa.final_mask or name != "one-byte"
    rng = np.random.default_rng(len(name))
    hay = rng.choice(np.frombuffer(b"abc\n", np.uint8), 3_000)
    for at in rng.integers(0, 2_900, 12):
        p = patterns[int(at) % len(patterns)]
        hay[at : at + len(p)] = np.frombuffer(p, np.uint8)
    hay[-len(patterns[0]) :] = np.frombuffer(patterns[0], np.uint8)
    hay[200 - len(patterns[-1]) : 200] = np.frombuffer(patterns[-1], np.uint8)
    hay_t = torch.from_numpy(hay.copy())
    for n in (hay.size, 200):
        want = brute_count(patterns, hay[:n].tobytes())
        assert want > 0
        assert S.shiftand_count_plain(sa, hay_t, n, chunk=64).item() == want
        assert JS.shiftand_count(JS.ShiftAndSet(patterns), hay[:n], interpret=True) == want


@pytest.mark.parametrize("charset", [b"\n\r\x0b\x0c", b"</>&'\"=[]", b"0123456789", b"aab"])
def test_one_byte_patterns_count_by_table(charset):
    """One-byte patterns (the find suite's charsets; duplicates too): the
    state after a byte is its mask, so the kernel's one-byte form counts
    popcount(mask[byte] & final) a byte, a table of 256 counts."""
    patterns = [bytes([c]) for c in charset]
    sa = S.ShiftAndSet(patterns)
    assert sa.max_len == 1 and sa.start_mask == sa.final_mask
    table = np.array([bin(int(m) & sa.final_mask).count("1") for m in sa.byte_masks])
    hay = np.random.default_rng(len(charset)).choice(np.frombuffer(charset + b"ab\x00", np.uint8), 2_000)
    want = JS.shiftand_count(JS.ShiftAndSet(patterns), hay, interpret=True)
    assert int((np.bincount(hay, minlength=256) * table).sum()) == want == brute_count(patterns, hay.tobytes()) > 0
    assert S.shiftand_count_plain(sa, torch.from_numpy(hay.copy())).item() == want


def test_extent_edges():
    sa = S.ShiftAndSet([b"\x00", b"ab\x00"])
    hay = np.frombuffer(b"ab\x00ab" * 200 + b"\x00" * 40, np.uint8)
    hay_t = torch.from_numpy(hay.copy())
    for n in (hay.size, hay.size - 40, 333, 3, 1, 0):
        assert S.shiftand_count(sa, hay_t, n) == brute_count(sa.patterns, hay[:n].tobytes()), n
    assert S.shiftand_count(S.ShiftAndSet([b"q" * 32]), torch.from_numpy(np.frombuffer(b"q" * 31, np.uint8).copy())) == 0
    assert S.shiftand_count(sa, torch.zeros(0, dtype=torch.uint8)) == 0


def test_kernel_table_layout():
    sa = S.ShiftAndSet(SEVEN)
    table, words = sa.tables("cpu")
    assert sa.tables(torch.device("cpu"))[0] is table
    raw = table.numpy().view(np.uint64)
    np.testing.assert_array_equal(raw[:256], sa.byte_masks)
    assert (int(raw[256]), int(raw[257])) == (sa.start_mask, sa.final_mask)
    assert words.shape == (2, 256)
    np.testing.assert_array_equal(words.numpy()[1], (sa.byte_masks >> np.uint64(32)).astype(np.int64))


def test_cuda_wrapper_refuses_cpu_tensors():
    before = dict(shiftand_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        shiftand_cuda.shiftand_count(S.ShiftAndSet([b"ab"]), torch.zeros(4096, dtype=torch.uint8))
    assert shiftand_cuda.LAUNCHES == before
