"""The port's byte-level BPE (``ops/bpe.py``) against the JAX package: the
trainer merge for merge, the merge table's arrays, and the encoder (XLA
``bpe_encode`` and the fused Pallas kernel in interpret mode, as
``tests/test_bpe.py`` runs it) on the same numpy inputs from a seed.

On the CPU the port's ``bpe_encode`` and ``bpe_encode_fused`` run
``bpe_encode_plain``, the semantics the CUDA kernel ``csrc/bpe.cu`` is held
to on the card. Ids and counts are integers: equality is exact, shapes
included. Every port table is carried over from the JAX table's arrays by
``MergeTable.from_numpy``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import bpe as JB
from stringwars_tpu.ops import bpe_pallas as JP
from stringwars_tpu.tape import PaddedTokens as JaxPaddedTokens
from stringwars_tpu_torch import datasets
from stringwars_tpu_torch.ops import bpe as B
from stringwars_tpu_torch.ops import bpe_cuda as BC
from stringwars_tpu_torch.unicode.pretokenize import gpt2_pretokens
from _torch_threads import one_thread  # noqa: F401


A, BB, C = ord("a"), ord("b"), ord("c")
HAND = [b"", b"a", b"aa", b"aaa", b"aaaa", b"aaaaa", b"ab", b"aab", b"aac", b"aacaac", b"abab", b"cabcab", b"bca"]


def words(rng, alphabet: bytes, lo: int, hi: int, count: int) -> list[bytes]:
    letters = np.frombuffer(alphabet, np.uint8)
    return [rng.choice(letters, int(rng.integers(lo, hi + 1))).tobytes() for _ in range(count)]


def carried(merges) -> tuple[JB.MergeTable, B.MergeTable]:
    """The JAX table and the port's, carried over from its arrays."""
    jt = JB.MergeTable.from_merges(merges)
    return jt, B.MergeTable.from_numpy(np.asarray(jt.sorted_keys), np.asarray(jt.ranks), np.asarray(jt.new_ids),
                                       jt.vocab_size)


def assert_encoders_equal_jax(tokens: list[bytes], merges, width: int | None = None) -> None:
    """The port's three encoders on the CPU equal the JAX XLA encoder and the
    JAX fused entry (the Pallas kernel in interpret mode up to 32 slots and
    4,096 merges, its XLA encoder past them)."""
    jt, table = carried(merges)
    data, lengths = B.pack_rows(tokens, width)
    jax_tokens = JaxPaddedTokens(data=jnp.asarray(data), lengths=jnp.asarray(lengths), width=data.shape[1])
    wants = [JB.bpe_encode(jax_tokens, jt), JP.bpe_encode_fused(jax_tokens, jt, interpret=True)]
    d, l = torch.from_numpy(data), torch.from_numpy(lengths)
    for got in (B.bpe_encode_plain(d, l, table), B.bpe_encode(d, l, table), B.bpe_encode_fused(d, l, table)):
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        for want in wants:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def multilingual_pretokens(count: int) -> list[bytes]:
    text = datasets.synthesize("multilingual", 64 << 10).decode("utf-8", "ignore")
    kept = [p for p in map(str.encode, gpt2_pretokens(text)) if 0 < len(p) <= 32]
    assert len(kept) >= count
    return kept[:count]


# --- trainer -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_train_merges_equals_jax_on_random_bytes(seed):
    rng = np.random.default_rng(seed)
    corpus = [bytes(rng.integers(0, 256, rng.integers(1, 20), dtype=np.uint8)) for _ in range(150)]
    corpus += [bytes(rng.integers(0, 4, rng.integers(0, 30), dtype=np.uint8)) for _ in range(300)]  # empties too
    assert B.train_merges(corpus, 60) == JB.train_merges(corpus, 60)


def test_train_merges_equals_jax_on_letters_and_text():
    rng = np.random.default_rng(3)
    corpus = words(rng, b"abcdef", 1, 11, 300)
    assert B.train_merges(corpus, 40) == JB.train_merges(corpus, 40)
    text = (b"the quick brown fox jumps over the lazy dog " * 30).split()
    assert B.train_merges(text, 30) == JB.train_merges(text, 30)
    # Ties: equal counts go to the smaller pair ids; training stops below 2.
    assert B.train_merges([b"ba", b"ab", b"cd", b"cd"], 10) == JB.train_merges([b"ba", b"ab", b"cd", b"cd"], 10) == [(C, ord("d"))]


def test_train_merges_equals_jax_on_multilingual_pretokens():
    """3,000 GPT-2 pretokens of synthetic:multilingual at 512 merges."""
    corpus = multilingual_pretokens(3000)
    got = B.train_merges(corpus, 512)
    assert got == JB.train_merges(corpus, 512)
    assert len(got) > 100


# --- merge table -------------------------------------------------------------


def test_merge_table_arrays_equal_jax(rng):
    merges = JB.train_merges(words(rng, b"abcde", 1, 16, 400), 50)
    jt = JB.MergeTable.from_merges(merges)
    table = B.MergeTable.from_merges(merges)
    np.testing.assert_array_equal(table.sorted_keys, np.asarray(jt.sorted_keys))
    np.testing.assert_array_equal(table.ranks, np.asarray(jt.ranks))
    np.testing.assert_array_equal(table.new_ids, np.asarray(jt.new_ids))
    assert table.vocab_size == jt.vocab_size and table.sorted_keys.dtype == np.uint32
    keys, ranks, new_ids, buckets = table.on("cpu")
    assert table.on("cpu")[3] is buckets and table.hashed() is table.hashed()  # staged and built once
    hashed = table.hashed()
    entries = buckets.numpy().view(np.uint32).reshape(-1, B.HASH_SLOTS, 2)
    np.testing.assert_array_equal(entries, hashed.buckets)
    homes = [B.bucket_of(table.sorted_keys, m, hashed.shift) for m in hashed.mults]
    for i, key in enumerate(table.sorted_keys):  # each entry once, in one of its key's two buckets
        where = [(b, j) for b in {homes[0][i], homes[1][i]} for j in range(B.HASH_SLOTS) if entries[b, j, 0] == key]
        assert len(where) == 1
        value = entries[where[0]][1]
        assert (value >> 16, value & 0xFFFF) == (table.ranks[i], table.new_ids[i])
    assert (entries[:, :, 1] == B.EMPTY_VALUE).sum() == entries.shape[0] * B.HASH_SLOTS - table.size


def test_merge_table_validation_equals_jax():
    for merges in ([(1, 2), (1, 2)], [(0, 0)] * ((1 << 16) - 255)):
        with pytest.raises(ValueError):
            JB.MergeTable.from_merges(merges)
        with pytest.raises(ValueError):
            B.MergeTable.from_merges(merges)
    keys = np.array([5, 9], np.uint32)
    with pytest.raises(ValueError):
        B.MergeTable.from_numpy(keys[::-1], [0, 1], [256, 257], 258)  # not ascending
    with pytest.raises(ValueError):
        B.MergeTable.from_numpy(keys, [0, 1 << 16], [256, 257], 258)  # rank past 16 bits
    with pytest.raises(ValueError):
        B.MergeTable.from_numpy(keys, [0], [256, 257], 258)  # lengths differ


# --- the hashed table the kernel reads ---------------------------------------


def merges_with_random_pairs(rng, total: int) -> list[tuple[int, int]]:
    """512 merges trained on fuzzed words, then random pairs up to ``total``."""
    merges = B.train_merges(words(rng, b"abcde", 1, 16, 2000), 512)
    seen = set(merges)
    while len(merges) < total:
        pair = (int(rng.integers(0, 256 + len(merges))), int(rng.integers(0, 256 + len(merges))))
        if pair not in seen:
            seen.add(pair)
            merges.append(pair)
    return merges


def crowded_merges(seed: int = 0, count: int = 5) -> list[tuple[int, int]]:
    """``count`` byte pairs whose keys all lie in bucket 0 under both of the
    first multipliers that ``build_hashed(seed=seed)`` draws, among the 8
    buckets of 5 keys: one bucket cannot hold them, so the build draws again."""
    mults = [int(m) | 1 for m in np.random.default_rng(seed).integers(0, 1 << 32, 2, dtype=np.uint64)]
    keys = np.arange(1 << 16, dtype=np.uint32)  # left << 16 | right over byte pairs ...
    keys = (keys >> 8) << 16 | (keys & 0xFF)
    shift = 32 - max(1, (count - 1).bit_length())  # the table's buckets: count at a load of one half
    crowded = keys[(B.bucket_of(keys, mults[0], shift) == 0) & (B.bucket_of(keys, mults[1], shift) == 0)][:count]
    return [(int(k) >> 16, int(k) & 0xFFFF) for k in crowded]


@pytest.mark.parametrize("total", [512, 30_000])
def test_hashed_lookup_equals_the_binary_search(total):
    """``lookup_hashed_plain`` walks the kernel's buckets; on every key of
    the table and on 10,000 absent keys it equals ``_lookup``."""
    rng = np.random.default_rng(20 + total)
    table = B.MergeTable.from_merges(merges_with_random_pairs(rng, total))
    assert BC.regime_of(table) == ("shared" if total == 512 else "global")
    present = torch.from_numpy(table.sorted_keys.astype(np.int64))
    absent = rng.integers(0, 1 << 32, 12_000, dtype=np.uint64)
    absent = torch.from_numpy(absent[~np.isin(absent, table.sorted_keys)][:10_000].astype(np.int64))
    edges = torch.tensor([table.hashed().empty_key, 0, 0xFFFFFFFF, 0xFFFF], dtype=torch.int64)
    for keys in (present, absent, edges):
        want, got = B._lookup(keys, table), B.lookup_hashed_plain(keys, table)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert (B.lookup_hashed_plain(absent, table)[0] == B.INF).all()
    hashed = table.hashed()
    assert hashed.buckets.shape[0] == {512: 512, 30_000: 32768}[total]  # a load of at most one half
    assert all(m & 1 for m in hashed.mults) and hashed.shift == 32 - hashed.buckets.shape[0].bit_length() + 1


def test_hashed_build_is_deterministic_and_checks_its_keys():
    rng = np.random.default_rng(21)
    keys = rng.choice(1 << 32, 3000, replace=False).astype(np.uint32)
    values = rng.integers(0, 1 << 31, 3000).astype(np.uint32)
    first, again, other = B.build_hashed(keys, values, 5), B.build_hashed(keys, values, 5), B.build_hashed(keys, values, 6)
    np.testing.assert_array_equal(first.buckets, again.buckets)
    assert (first.mults, first.kicks, first.attempts) == (again.mults, again.kicks, again.attempts)
    assert other.mults != first.mults
    with pytest.raises(ValueError):
        B.build_hashed(np.array([7, 9, 7], np.uint32), np.array([1, 2, 3], np.uint32))  # a duplicate key
    with pytest.raises(ValueError):
        B.build_hashed(np.array([7], np.uint32), np.array([B.EMPTY_VALUE], np.uint32))  # the empty value
    empty = B.build_hashed(np.array([], np.uint32), np.array([], np.uint32))
    assert empty.buckets.shape == (2, B.HASH_SLOTS, 2) and (empty.buckets[:, :, 1] == B.EMPTY_VALUE).all()


def test_hashed_build_draws_again_and_kicks():
    """Five keys crowded into one bucket under the first multipliers: the
    build draws a second pair; the 30,000-merge table moves entries on."""
    merges = crowded_merges()
    assert len(merges) == 5
    table = B.MergeTable.from_merges(merges)
    assert table.hashed().attempts >= 2 and table.hashed().buckets.shape[0] == 8
    keys = torch.from_numpy(table.sorted_keys.astype(np.int64))
    np.testing.assert_array_equal(B.lookup_hashed_plain(keys, table)[0].numpy(), B._lookup(keys, table)[0].numpy())
    big = B.MergeTable.from_merges(merges_with_random_pairs(np.random.default_rng(22), 30_000))
    assert big.hashed().kicks > 0


def test_plain_encoder_with_the_hashed_lookup_equals_jax(monkeypatch):
    """``bpe_encode_plain`` looking pairs up as the kernel does, on a
    shuffled batch of mixed lengths (short rows beside 32-byte ones), equals
    the JAX encoders (the fused kernel in interpret mode); also under the
    crowded table whose build drew twice."""
    rng = np.random.default_rng(23)
    corpus = words(rng, b"abcd", 0, 32, 200) + words(rng, b"abcd", 1, 4, 100) + HAND
    corpus = [corpus[i] for i in rng.permutation(len(corpus))]
    merges = JB.train_merges(corpus, 60)
    monkeypatch.setattr(B, "_lookup", B.lookup_hashed_plain)
    assert_encoders_equal_jax(corpus, merges)
    crowded = crowded_merges()
    letters = bytes(sorted({b for pair in crowded for b in pair}))
    assert_encoders_equal_jax(words(rng, letters, 0, 12, 150), crowded)


# --- encoder -----------------------------------------------------------------


def test_hand_merges_equal_jax():
    assert_encoders_equal_jax(HAND, [(A, A), (A, BB), (256, C), (257, 257)])


def test_overlap_runs_equal_jax():
    assert_encoders_equal_jax([b"a" * n for n in range(1, 33)], [(A, A), (256, 256), (257, A)])


@pytest.mark.parametrize("alphabet,lo,hi", [(b"abc", 1, 16), (b"abcde", 1, 16), (b"abcd", 17, 32), (b"abc", 0, 32)])
def test_fuzzed_words_equal_jax(alphabet, lo, hi):
    """Fuzzed words over 3-5 letters at widths up to 16 and 17-32."""
    rng = np.random.default_rng(len(alphabet) * 100 + hi)
    corpus = words(rng, alphabet, lo, hi, 500) + [b"aaaaaaaaaaa", b"ababababab", b"aabbaabb", b"a", b"abcabcabcabc"]
    assert_encoders_equal_jax(corpus, JB.train_merges(corpus, 40))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    corpus = [bytes(rng.integers(0, 256, rng.integers(0, 33), dtype=np.uint8)) for _ in range(300)]
    merges = JB.train_merges(corpus + words(rng, b"\x00\xff\x80", 2, 20, 200), 25)
    assert_encoders_equal_jax(corpus, merges)


def test_wider_than_32_equals_jax():
    """A batch wider than the kernel's 32 slots: the binary-search encoder."""
    rng = np.random.default_rng(8)
    corpus = words(rng, b"abcd", 0, 70, 200)
    assert B.pack_rows(corpus)[0].shape[1] > 32
    assert_encoders_equal_jax(corpus, JB.train_merges(corpus, 60))


def test_large_table_equals_jax():
    """30,000 merges (the kernel's global-memory regime): 512 trained, the
    rest random pairs, on the multilingual pretokens. JAX's fused entry
    sends a table past 4,096 rules to its XLA encoder too."""
    rng = np.random.default_rng(9)
    corpus = multilingual_pretokens(3000)
    merges = JB.train_merges(corpus, 512)
    seen = set(merges)
    while len(merges) < 30_000:
        pair = (int(rng.integers(0, 256 + len(merges))), int(rng.integers(0, 256 + len(merges))))
        if pair not in seen:
            seen.add(pair)
            merges.append(pair)
    assert BC.regime_of(B.MergeTable.from_merges(merges)) == "global"
    assert BC.regime_of(B.MergeTable.from_merges(merges[:512])) == "shared"
    assert_encoders_equal_jax(corpus[:800], merges)


def test_no_merges_compacts_only():
    data, lengths = B.pack_rows([b"", b"abc", b"x"])
    ids, counts = B.bpe_encode_plain(torch.from_numpy(data), torch.from_numpy(lengths), B.MergeTable.from_merges([]))
    assert ids.tolist() == [[-1, -1, -1], [97, 98, 99], [120, -1, -1]] and counts.tolist() == [0, 3, 1]


def test_encoder_equals_the_oracle_and_counts_iterations():
    """Rows equal ``bpe_encode_ref`` (the port's equals the JAX oracle), and
    a row's iterations are its merging rounds in the oracle plus one; its
    slots and pairs are the oracle's sequence lengths, and those less one,
    summed over those iterations. The second batch's "ab" merges in each of
    the loop's W - 1 iterations, so its last one lies past the loop."""
    rng = np.random.default_rng(4)
    corpus = words(rng, b"abcde", 0, 32, 400) + HAND
    for corpus, merges in ((corpus, JB.train_merges(corpus, 40)), ([b"ab", b"a", b"", b"ba"], [(97, 98)])):
        check_iterations(corpus, merges)


def check_iterations(corpus: list[bytes], merges: list[tuple[int, int]]) -> None:
    data, lengths = B.pack_rows(corpus)
    ids, counts, work = B.bpe_encode_plain(torch.from_numpy(data), torch.from_numpy(lengths),
                                           B.MergeTable.from_merges(merges), work=True)
    rank = {pair: r for r, pair in enumerate(merges)}
    for i, token in enumerate(corpus):
        want = B.bpe_encode_ref(token, merges)
        assert want == JB.bpe_encode_ref(token, merges)
        assert ids[i, : counts[i]].tolist() == want and (ids[i, counts[i]:] == -1).all()
        seq, merged = list(token), 0
        slots, pairs = len(seq), max(len(seq) - 1, 0)
        while any(pair in rank for pair in zip(seq, seq[1:])):  # one round: every occurrence of the best pair
            best = min(rank.get(pair, 1 << 30) for pair in zip(seq, seq[1:]))
            out, j = [], 0
            while j < len(seq):
                hit = j + 1 < len(seq) and (seq[j], seq[j + 1]) == merges[best]
                out.append(256 + best if hit else seq[j])
                j += 2 if hit else 1
            seq, merged = out, merged + 1
            slots, pairs = slots + len(seq), pairs + len(seq) - 1
        assert seq == want and int(work["iterations"][i]) == merged + 1, token
        assert (int(work["slots"][i]), int(work["pairs"][i])) == (slots, pairs), token


def test_pack_rows_equals_the_jax_staging_loop(rng):
    tokens = words(rng, b"abcxyz", 0, 25, 300)
    data, lengths = B.pack_rows(tokens)
    want = np.zeros((len(tokens), max(map(len, tokens))), np.uint8)
    for i, t in enumerate(tokens):
        want[i, : len(t)] = np.frombuffer(t, np.uint8)
    np.testing.assert_array_equal(data, want)
    np.testing.assert_array_equal(lengths, [len(t) for t in tokens])
    assert B.pack_rows([])[0].shape == (0, 1) and B.pack_rows([b"ab"], 5)[0].shape == (1, 5)
    with pytest.raises(ValueError):
        B.pack_rows([b"abc"], 2)


def test_dispatch_and_what_the_kernel_does_not_take():
    table = B.MergeTable.from_merges([(A, A)])
    data, lengths = (torch.from_numpy(a) for a in B.pack_rows([b"aaa"]))
    assert B.bpe_encode_fused is B.bpe_encode
    assert B.bpe_encode(data, lengths, table)[0].tolist() == [[256, 97, -1]]
    with pytest.raises(ValueError):
        BC.bpe_encode(data, lengths, table)  # the kernel needs the card
    with pytest.raises(ValueError):
        B.bpe_encode(data.to(torch.int32), lengths, table)  # not bytes
    with pytest.raises(ValueError):
        B.bpe_encode(data, lengths[:0], table)  # one length a row
    with pytest.raises(ValueError):
        B.bpe_encode(data, lengths, [(A, A)])  # not a MergeTable


def full_shape_trainer() -> None:
    """Both trainers at the tokenization suite's shape, in this process:
    GPT-2's pre-split of the first 4 Mi characters of 16 MB of
    ``synthetic:multilingual``, its first 400,000 pretokens of 1 to 32 B,
    512 merges trained on the first 30,000. The merge lists must be equal;
    prints the seconds of the pre-split and of each trainer."""
    import time

    from stringwars_tpu_torch.suites import tokenization as suite

    text = datasets.synthesize("multilingual", 16 << 20).decode("utf-8", "ignore")[: suite.BPE_CHARS]
    started = time.perf_counter()
    kept, _ = suite.bpe_rows(text, suite.BPE_ROWS)
    split = time.perf_counter()
    port = B.train_merges(kept[: suite.BPE_TRAIN], suite.BPE_MERGES)
    trained = time.perf_counter()
    reference = JB.train_merges(kept[: suite.BPE_TRAIN], suite.BPE_MERGES)
    done = time.perf_counter()
    assert port == reference, "the trainers' merges differ"
    print(f"{len(kept):,} pretokens ({sum(map(len, kept)):,} B) of {len(text):,} characters; pre-split "
          f"{split - started:.3f} s; {len(port)} merges, equal: port trainer {trained - split:.3f} s, "
          f"JAX trainer {done - trained:.3f} s")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bpe.py
    full_shape_trainer()
