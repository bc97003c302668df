"""Dataset layer (L1): corpus loading, generation, and stderr statistics.

The port of ``stringwars_tpu.datasets``: read a corpus file (path from
``SWTPU_DATASET`` or ``--dataset``), cap its size (``--dataset-limit``),
tokenize into lines/words/file granularity honoring ``SWTPU_MAX_TOKENS`` and
``SWTPU_UNIQUE``, and log token-count/size stats with an 18-bucket log2
length histogram to stderr.

The six synthetic corpora produce the same bytes as the JAX package's
generators for the same ``np.random.Generator``. One difference: each corpus
is seeded with ``zlib.crc32(name)``, which is the same in every process. The
JAX package seeds with ``hash(name)``, which Python randomizes per process, so
its corpora differ from run to run.
"""

from __future__ import annotations

import sys
import zlib

import numpy as np

from stringwars_tpu_torch.tape import Tape
from stringwars_tpu_torch.utils.config import get_env, get_env_bool, get_env_parsed, parse_size

DEFAULT_SEED = 42


def load_corpus(
    dataset_path: str | None = None,
    *,
    size_limit: str | None = "128mb",
    default_synthetic: str = "english-words",
) -> bytes:
    """Read the corpus file, or synthesize a deterministic one when unset.

    ``SWTPU_DATASET`` may name a file path or a synthetic corpus
    (``synthetic:<name>``).
    """
    path = dataset_path if dataset_path is not None else get_env("DATASET")
    max_bytes = parse_size(size_limit) if size_limit else None
    if path is None or path.startswith("synthetic:"):
        name = path.split(":", 1)[1] if path else default_synthetic
        size = max_bytes if max_bytes else 128 << 20
        data = synthesize(name, size, seed=get_env_parsed("SEED", DEFAULT_SEED))
        print(f"Dataset: synthetic:{name} ({len(data):,} bytes, seed fixed)", file=sys.stderr)
        return data
    with open(path, "rb") as f:
        return f.read(max_bytes) if max_bytes is not None else f.read()


def load_tape(
    dataset_path: str | None = None,
    *,
    tokens_mode: str = "words",
    size_limit: str | None = "128mb",
    default_synthetic: str = "english-words",
    device=None,
) -> Tape:
    """End-to-end: load corpus → tokenize → tape on ``device`` → stderr stats."""
    data = load_corpus(dataset_path, size_limit=size_limit, default_synthetic=default_synthetic)
    max_tokens = get_env_parsed("MAX_TOKENS", 0) or None
    unique = get_env_bool("UNIQUE")
    tape = Tape.from_buffer(data, tokens_mode, max_tokens=max_tokens, unique=unique, device=device)
    log_tape_stats(tape, tokens_mode)
    return tape


def log_tape_stats(tape: Tape, mode: str) -> None:
    """Token stats + 18-bucket log2 length histogram, to stderr."""
    offsets = tape.offsets.cpu().numpy()
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int64)
    total = int(lengths.sum())
    count = lengths.shape[0]
    mean = total / max(count, 1)
    print(
        f"Loaded {count:,} {mode} tokens, {total:,} bytes, mean length {mean:.1f} B",
        file=sys.stderr,
    )
    if count:
        buckets = np.clip(np.floor(np.log2(np.maximum(lengths, 1))).astype(np.int64), 0, 17)
        hist = np.bincount(buckets, minlength=18)
        for b in range(18):
            if hist[b]:
                lo, hi = (1 << b), (1 << (b + 1)) - 1
                print(f"  [{lo:>6}-{hi:>6} B] {int(hist[b]):>12,}", file=sys.stderr)


# ---------------------------------------------------------------------------
# Synthetic corpora
# ---------------------------------------------------------------------------

_CORPORA = {}


def corpus_names() -> list[str]:
    return sorted(_CORPORA)


def corpus_seed(name: str) -> int:
    """The per-corpus half of the seed: stable across processes."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def synthesize(name: str, size: int, *, seed: int = DEFAULT_SEED) -> bytes:
    """Generate ~``size`` bytes of the named corpus, deterministically."""
    try:
        generator = _CORPORA[name]
    except KeyError:
        raise ValueError(f"Unknown synthetic corpus {name!r}; choose from {corpus_names()}") from None
    return generator(size, np.random.default_rng([seed, corpus_seed(name)]))


def _register(name):
    def wrap(fn):
        _CORPORA[name] = fn
        return fn

    return wrap


def _zipf_vocabulary(rng: np.random.Generator, vocab_size: int, alphabet: np.ndarray, mean_len: float):
    """A vocabulary of random words with Zipf-ranked frequencies."""
    lengths = np.clip(rng.poisson(mean_len, vocab_size), 1, 4 * int(mean_len) + 2)
    words = [alphabet[rng.integers(0, alphabet.size, l)].tobytes() for l in lengths]
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return words, probs


def _compose_words(size: int, rng, words, probs, separator: bytes = b" ", line_words: int | None = None) -> bytes:
    """Words drawn in batches of 65,536, each followed by ``separator`` or,
    after every ``line_words``-th word, by a newline.

    The same bytes and the same draws as the JAX package's word-at-a-time
    loop: that loop stops drawing once the output reaches ``size`` and
    truncates to ``size``, so assembling each whole batch with numpy and
    truncating at the end changes nothing but the speed.
    """
    vlen = np.fromiter((len(w) for w in words), dtype=np.int64, count=len(words))
    vstart = np.cumsum(vlen) - vlen
    vocab = np.frombuffer(b"".join(words), dtype=np.uint8)
    sep = np.frombuffer(separator, dtype=np.uint8)
    batch = 65536
    chunks: list[bytes] = []
    produced = 0
    drawn = 0
    while produced < size:
        idx = rng.choice(len(words), size=batch, p=probs)
        wl, ws = vlen[idx], vstart[idx]
        ordinal = drawn + 1 + np.arange(batch, dtype=np.int64)
        newline = (ordinal % line_words == 0) if line_words else np.zeros(batch, dtype=bool)
        piece = wl + np.where(newline, 1, sep.size)
        pos = np.cumsum(piece) - piece
        buf = np.empty(int(piece.sum()), dtype=np.uint8)
        within = np.arange(int(wl.sum()), dtype=np.int64) - np.repeat(np.cumsum(wl) - wl, wl)
        buf[np.repeat(pos, wl) + within] = vocab[np.repeat(ws, wl) + within]
        tail = pos + wl
        buf[tail[newline]] = 0x0A
        for j in range(sep.size):
            buf[tail[~newline] + j] = sep[j]
        chunks.append(buf.tobytes())
        produced += buf.size
        drawn += batch
    return b"".join(chunks)[:size]


@_register("english-words")
def _english_words(size: int, rng) -> bytes:
    """ASCII words, Zipf frequencies, ~5.5 B mean length, newline every ~12 words."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    words, probs = _zipf_vocabulary(rng, 30_000, alphabet, 5.5)
    return _compose_words(size, rng, words, probs, line_words=12)


@_register("long-lines")
def _long_lines(size: int, rng) -> bytes:
    """~1 KB lines of ASCII words — the reference's 'long lines' shape."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", dtype=np.uint8)
    words, probs = _zipf_vocabulary(rng, 50_000, alphabet, 6.0)
    return _compose_words(size, rng, words, probs, line_words=150)


@_register("dna")
def _dna(size: int, rng) -> bytes:
    """ACGT sequences, one 1 KB read per line (similarities workloads)."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    flat = acgt[rng.integers(0, 4, size)]
    flat[1023::1024] = 0x0A
    return flat.tobytes()


@_register("dna-100b")
def _dna_100b(size: int, rng) -> bytes:
    """ACGT with 100-byte reads per line."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    flat = acgt[rng.integers(0, 4, size)]
    flat[100::101] = 0x0A
    return flat.tobytes()


def _range_alphabet(*ranges: tuple[int, int]) -> list[str]:
    chars = []
    for lo, hi in ranges:
        chars.extend(chr(c) for c in range(lo, hi))
    return chars


@_register("multilingual")
def _multilingual(size: int, rng) -> bytes:
    """UTF-8 mix of Latin/German/Cyrillic/Greek/Hangul/CJK/Arabic words,
    every string valid UTF-8 with multi-byte sequences of widths 1-3."""
    pools = [
        _range_alphabet((0x61, 0x7B)),  # a-z
        _range_alphabet((0x61, 0x7B)) + list("äöüßéèê"),  # German/French Latin-1
        _range_alphabet((0x430, 0x450)),  # Cyrillic
        _range_alphabet((0x3B1, 0x3CA)),  # Greek
        _range_alphabet((0xAC00, 0xAC00 + 256)),  # Hangul syllables
        _range_alphabet((0x4E00, 0x4E00 + 256)),  # CJK
        _range_alphabet((0x627, 0x64B)),  # Arabic
    ]
    out = bytearray()
    while len(out) < size:
        pool = pools[int(rng.integers(0, len(pools)))]
        for _ in range(200):
            word_len = int(rng.integers(1, 9))
            chars = rng.integers(0, len(pool), word_len)
            out += "".join(pool[c] for c in chars).encode("utf-8")
            out += b"\n" if rng.integers(0, 12) == 0 else b" "
            if len(out) >= size:
                break
    # Trim to a UTF-8 boundary: drop trailing continuation bytes.
    end = size
    while end > 0 and (out[end - 1] & 0xC0) == 0x80:
        end -= 1
    if end > 0 and out[end - 1] >= 0xC0:
        end -= 1
    return bytes(out[:end])


@_register("naughty")
def _naughty(size: int, rng) -> bytes:
    """Adversarial strings: empties, huge tokens, NULs, all byte values,
    UTF-8 edge sequences."""
    pieces: list[bytes] = [
        b"",
        b"\x00" * 17,
        bytes(range(256)),
        "\x00\uffff\U0010ffff".encode("utf-8"),
        "ß SS ss ẞ".encode("utf-8"),
        "é é ﬁ ﬂ".encode("utf-8"),
        "가각갂 각".encode("utf-8"),
        b"a" * 4096,
    ]
    out = bytearray()
    ascii_pool = np.frombuffer(bytes(range(0x20, 0x7F)), dtype=np.uint8)
    while len(out) < size:
        if rng.integers(0, 4) == 0:
            out += pieces[int(rng.integers(0, len(pieces)))]
        else:
            n = int(rng.integers(1, 40))
            out += ascii_pool[rng.integers(0, ascii_pool.size, n)].tobytes()
        out += b"\n"
    return bytes(out[:size])
