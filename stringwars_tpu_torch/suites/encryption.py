"""Encryption suite: AEAD keygen / encryption / decryption (reference
``encryption/bench.rs``; defaults: lines tokens of ``synthetic:long-lines``,
5 s warm-up + 10 s measure).

The port of ``stringwars_tpu.suites.encryption`` for one device. The AEADs
on the device are ChaCha20-Poly1305 and XChaCha20-Poly1305
(``ops/chacha.py``: the keystream and MAC kernels of ``csrc/chacha.cu`` on a
card, the plain torch versions with ``--device cpu``); AES-GCM and the
reference's OpenSSL ChaCha20-Poly1305 are host rows through the
``cryptography`` module, SKIPPED where it is missing. Rows:

- ``keygen``: a fresh 256-bit key and a cipher-sized nonce per call from the
  device's counter-based generator (``memops.fill_random``), read back to
  the host; ``fill_random`` alone fills a 32-byte key.
- ``encryption``: per-token rows seal the corpus's first 64 tokens (staged
  on the device once), one counter nonce each, the counter advancing
  across calls; the ``-corpus`` rows seal the whole corpus in one call,
  keystream XOR plus the whole tag, on device-resident data.
- ``decryption``: the ``-corpus`` rows open the ciphertext sealed once at
  staging (the MAC check, then the XOR back) and report plaintext bytes, as
  the reference does (``encryption/bench.rs:362-367``).

The JAX package's chained-loop salt protocol (its corpus rows perturb the
key each iteration and MAC only whole chunks of full blocks) is not ported:
a local card runs every launch, and each corpus call here computes the real
tag of the whole message. ``ctx.staged`` keeps the last corpus ciphertext
and tag of each row, the opened plaintexts and the per-token seals, for the
caller's checks.
"""

from __future__ import annotations

import torch

from stringwars_tpu_torch.ops import chacha as CC
from stringwars_tpu_torch.ops.memops import fill_random
from stringwars_tpu_torch.suites._common import SuiteContext, setup_suite
from stringwars_tpu_torch.utils.harness import WorkUnits

KEY = bytes(range(32))
SAMPLE_TOKENS = 64
CORPUS_NONCE = {"chacha20poly1305": 0, "xchacha20poly1305": 7}  # counter nonces of the corpus rows


def counter_nonce(i: int, size: int = 12) -> bytes:
    """The ``i``-th nonce of a counter, little-endian, ``size`` bytes."""
    return i.to_bytes(size, "little")


def device_ciphers() -> list[tuple[str, int, object, object]]:
    """(label, nonce_len, encrypt(key, nonce, pt) -> (ct, tag),
    decrypt(key, nonce, ct, tag) -> pt) for the AEADs on the device."""
    return [
        ("chacha20poly1305", 12, CC.aead_encrypt, CC.aead_decrypt),
        ("xchacha20poly1305", 24, CC.xchacha_aead_encrypt, CC.xchacha_aead_decrypt),
    ]


def bench_keygen(ctx: SuiteContext) -> None:
    seed_box = [0]

    def keygen_factory(n: int, device: torch.device):
        def routine() -> WorkUnits:
            seed_box[0] += 1
            fill_random(seed_box[0], n, device).cpu()
            return WorkUnits(elements=1, bytes=n)

        return routine

    scope = ctx.scopes[0]
    for label, nonce_len, _, _ in device_ciphers():
        ctx.run(f"keygen/swtorch::{label}{scope.name}", "bytes",
                lambda n=32 + nonce_len, d=scope.device: keygen_factory(n, d), scope=scope)

    def host_factory():
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        def routine() -> WorkUnits:
            AESGCM.generate_key(bit_length=256)
            counter_nonce(seed_box[0], 12)
            return WorkUnits(elements=1, bytes=32 + 12)

        return routine

    ctx.run("keygen/cryptography.AESGCM", "bytes", host_factory)
    ctx.run(f"keygen/swtorch::fill_random{scope.name}", "bytes", lambda d=scope.device: keygen_factory(32, d),
            scope=scope)


def bench_encryption(ctx: SuiteContext, sample: list[bytes], corpus: torch.Tensor) -> None:
    staged = ctx.staged
    sample_bytes = sum(map(len, sample))
    nonce_counter = [0]
    scope = ctx.scopes[0]
    tokens = [torch.tensor(list(t), dtype=torch.uint8, device=scope.device) for t in sample]
    for label, nonce_len, encrypt, _ in device_ciphers():

        def sample_factory(label=label, nonce_len=nonce_len, encrypt=encrypt):
            def routine() -> WorkUnits:
                base = nonce_counter[0]
                nonce_counter[0] += len(tokens)
                seals = []
                for i, token in enumerate(tokens):
                    nonce = counter_nonce(base + i, nonce_len)
                    seals.append((nonce, *encrypt(KEY, nonce, token)))
                staged["seals"][label] = seals
                return WorkUnits(elements=len(tokens), bytes=sample_bytes)

            return routine

        ctx.run(f"encryption/swtorch::{label}{scope.name}", "bytes", sample_factory, scope=scope)
    for label, nonce_len, encrypt, _ in device_ciphers():

        def corpus_factory(label=label, nonce_len=nonce_len, encrypt=encrypt):
            data = corpus.to(scope.device)
            nonce = counter_nonce(CORPUS_NONCE[label], nonce_len)

            def routine() -> WorkUnits:
                staged["sealed"][label] = (nonce, *encrypt(KEY, nonce, data))
                return WorkUnits(elements=1, bytes=data.numel())

            return routine

        ctx.run(f"encryption/swtorch::{label}-corpus{scope.name}", "bytes", corpus_factory, scope=scope)

    def host_factory(cipher_name: str):
        def factory():
            from cryptography.hazmat.primitives.ciphers import aead

            cipher = getattr(aead, cipher_name)(KEY)

            def routine() -> WorkUnits:
                for i, token in enumerate(sample):
                    cipher.encrypt(counter_nonce(i), token, None)
                return WorkUnits(elements=len(sample), bytes=sample_bytes)

            return routine

        return factory

    for cipher_name in ("AESGCM", "ChaCha20Poly1305"):
        ctx.run(f"encryption/cryptography.{cipher_name}", "bytes", host_factory(cipher_name))


def bench_decryption(ctx: SuiteContext, corpus: torch.Tensor) -> None:
    staged = ctx.staged
    scope = ctx.scopes[0]
    for label, nonce_len, encrypt, decrypt in device_ciphers():

        def factory(label=label, nonce_len=nonce_len, encrypt=encrypt, decrypt=decrypt):
            nonce = counter_nonce(CORPUS_NONCE[label], nonce_len)
            ct, tag = encrypt(KEY, nonce, corpus.to(scope.device))

            def routine() -> WorkUnits:
                staged["opened"][label] = decrypt(KEY, nonce, ct, tag)
                return WorkUnits(elements=1, bytes=ct.numel())

            return routine

        ctx.run(f"decryption/swtorch::{label}-corpus{scope.name}", "bytes", factory, scope=scope)


def main(argv: list[str] | None = None) -> SuiteContext:
    """Run the suite; returns its context, whose ``staged`` holds the corpus
    on the device, the sample tokens, and the last results of each row."""
    ctx = setup_suite(
        "AEAD throughput (ChaCha20/XChaCha20-Poly1305 on the device; AES-GCM on the host)",
        default_tokens="lines",
        default_warmup=5.0,
        default_time=10.0,
        default_synthetic="long-lines",
        argv=argv,
    )
    tape = ctx.tape
    corpus = tape.data[: tape.total_bytes]
    head = tape.subtape(0, min(tape.count, 4096)).to_list()
    sample = [t for t in head if t][:SAMPLE_TOKENS]
    ctx.staged = {"corpus": corpus, "key": KEY, "sample": sample, "seals": {}, "sealed": {}, "opened": {}}

    ctx.group("keygen")
    bench_keygen(ctx)
    ctx.group("encryption")
    bench_encryption(ctx, sample, corpus)
    ctx.group("decryption")
    bench_decryption(ctx, corpus)
    return ctx


if __name__ == "__main__":
    main()
