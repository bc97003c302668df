"""The port's encryption suite end to end on the CPU (``--device cpu``, 1 MB
of ``synthetic:long-lines``, ``SWTPU_TIME=0``), against the JAX package's
AEAD on the same corpus."""

import contextlib
import io

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

from stringwars_tpu.ops import chacha as JC
from stringwars_tpu_torch.ops import chacha as C
from stringwars_tpu_torch.suites import encryption as enc_suite
from _torch_threads import one_thread  # noqa: F401


ROWS = [
    "keygen/swtorch::chacha20poly1305<1cpu>",
    "keygen/swtorch::xchacha20poly1305<1cpu>",
    "keygen/cryptography.AESGCM",
    "keygen/swtorch::fill_random<1cpu>",
    "encryption/swtorch::chacha20poly1305<1cpu>",
    "encryption/swtorch::xchacha20poly1305<1cpu>",
    "encryption/swtorch::chacha20poly1305-corpus<1cpu>",
    "encryption/swtorch::xchacha20poly1305-corpus<1cpu>",
    "encryption/cryptography.AESGCM",
    "encryption/cryptography.ChaCha20Poly1305",
    "decryption/swtorch::chacha20poly1305-corpus<1cpu>",
    "decryption/swtorch::xchacha20poly1305-corpus<1cpu>",
]


@pytest.fixture(scope="module")
def suite_run():
    mp = pytest.MonkeyPatch()
    mp.setenv("SWTPU_TIME", "0")
    mp.setenv("SWTPU_WARMUP", "0")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ctx = enc_suite.main(["--device", "cpu", "--dataset-limit", "1mb"])
    mp.undo()
    return ctx, out.getvalue().splitlines()


def test_every_row_reports(suite_run):
    _, lines = suite_run
    for row in ROWS:
        hits = [line for line in lines if line.startswith(row + " ")]
        assert len(hits) == 1 and "SKIPPED" not in hits[0] and "/s" in hits[0], (row, lines)
    assert [line for line in lines if line.startswith("# ")] == ["# keygen", "# encryption", "# decryption"]


def test_corpus_seals_equal_jax(suite_run):
    ctx, _ = suite_run
    staged = ctx.staged
    corpus = staged["corpus"].numpy()
    assert corpus.size >= 1_000_000 and corpus.size == ctx.tape.total_bytes
    nonce, ct, tag = staged["sealed"]["chacha20poly1305"]
    want_ct, want_tag = JC.aead_encrypt(enc_suite.KEY, nonce, corpus)
    assert ct.numpy().tobytes() == want_ct.tobytes() and tag == want_tag
    assert ct.numpy().tobytes() + tag == ChaCha20Poly1305(enc_suite.KEY).encrypt(nonce, corpus.tobytes(), None)
    nonce24, xct, xtag = staged["sealed"]["xchacha20poly1305"]
    want_ct, want_tag = JC.xchacha_aead_encrypt(enc_suite.KEY, nonce24, corpus)
    assert xct.numpy().tobytes() == want_ct.tobytes() and xtag == want_tag


def test_decryption_rows_give_back_the_corpus(suite_run):
    ctx, _ = suite_run
    for label in ("chacha20poly1305", "xchacha20poly1305"):
        assert torch.equal(ctx.staged["opened"][label], ctx.staged["corpus"])


def test_per_token_seals_equal_the_oracle(suite_run):
    ctx, _ = suite_run
    sample = ctx.staged["sample"]
    assert len(sample) == enc_suite.SAMPLE_TOKENS and all(sample)
    seals = ctx.staged["seals"]["chacha20poly1305"]
    nonces = [nonce for nonce, _, _ in seals]
    assert len(set(nonces)) == len(seals) == len(sample)
    for token, (nonce, ct, tag) in list(zip(sample, seals))[:8]:
        assert (ct.numpy().tobytes(), tag) == C.aead_ref(enc_suite.KEY, nonce, token)
    for token, (nonce, ct, tag) in list(zip(sample, ctx.staged["seals"]["xchacha20poly1305"]))[:8]:
        want_ct, want_tag = JC.xchacha_aead_encrypt(enc_suite.KEY, nonce, np.frombuffer(token, np.uint8))
        assert ct.numpy().tobytes() == want_ct.tobytes() and tag == want_tag


def test_suite_main_without_a_card_stops(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as stop:
        enc_suite.main(["--dataset-limit", "64kb"])
    assert stop.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
