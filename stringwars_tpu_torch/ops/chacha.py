"""ChaCha20-Poly1305 and XChaCha20-Poly1305 AEAD (family K13, RFC 8439).

The port of ``stringwars_tpu.ops.chacha``. The data is a 1-D ``uint8``
tensor; the cipher and the MAC run on its device:

- ``chacha20_xor(key, nonce, data, counter=1)``: ``data`` XOR the ChaCha20
  keystream, block b at the counter ``(counter + b) mod 2^32``, any length.
- ``poly1305_tag(key32, message)``: the 16-byte Poly1305 tag, as bytes.
- ``aead_encrypt`` / ``aead_decrypt`` (RFC 8439 §2.8) and their XChaCha
  forms (draft-irtf-cfrg-xchacha §2.3: the HChaCha20 subkey of the first 16
  nonce bytes, the nonce ``bytes(4) + nonce24[16:]``). Encrypt returns the
  ciphertext on the data's device and the tag as bytes; decrypt reads back
  the 16-byte tag once, compares it with ``hmac.compare_digest`` and raises
  ``ValueError`` on a mismatch before it deciphers.

On a CUDA tensor the keystream and the MAC are the kernels of
``csrc/chacha.cu`` (``chacha20_xor_cuda``, ``poly1305_cuda``): the whole
tag, tail included, is computed on the card, and the AEAD's one-time key is
read by the MAC kernel where the keystream kernel wrote it. On a CPU tensor
they are the plain torch versions (``chacha20_xor_plain``,
``poly1305_plain``): the keystream in int64 ops masked to 32 bits, the MAC
a pairwise Horner tree in 13-bit limbs. ``chacha20_block_ref``,
``poly1305_ref`` and ``aead_ref`` are host oracles in Python integers,
written from RFC 8439 §2.3-2.8.

Not ported: the JAX package's limb conversion for its chained-loop corpus
rows (``limbs_from_u32``), its per-key host power table
(``_r_power_limbs``) and its host fold of chunk partials.
"""

from __future__ import annotations

import hmac

import torch

from stringwars_tpu_torch import build

# Launches of csrc/chacha.cu's entry points since process start (or the last reset).
LAUNCHES = {"chacha20_xor": 0, "poly1305": 0}

_M32 = 0xFFFFFFFF
_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
_P1305 = (1 << 130) - 5
_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
POLY_WARPS = 8  # warps a block of csrc/chacha.cu's MAC kernel
POLY_ONE_LAUNCH = 32 * POLY_WARPS * 4  # MAC-input blocks that one launch (one block) takes: 16 KiB
POLY_BLOCKS_PER_SM = 3  # the persistent grid of a longer message (csrc/chacha.cu kPolyBlocksPerSm)
TILE_BYTES = 2048  # a warp's tile in csrc/chacha.cu's keystream kernel: 32 blocks


def _check_key_nonce(key: bytes, nonce: bytes, nonce_len: int = 12) -> None:
    if len(key) != 32 or len(nonce) != nonce_len:
        raise ValueError(f"key must be 32 bytes, nonce {nonce_len} bytes")


def _le_words(data: bytes) -> list[int]:
    return [int.from_bytes(data[i : i + 4], "little") for i in range(0, len(data), 4)]


# ---------------------------------------------------------------------------
# Host oracles (Python integers, RFC 8439)
# ---------------------------------------------------------------------------

def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def _quarter_ref(x: list[int], a: int, b: int, c: int, d: int) -> None:
    x[a] = (x[a] + x[b]) & _M32
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & _M32
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & _M32
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & _M32
    x[b] = _rotl(x[b] ^ x[c], 7)


def _double_rounds_ref(x: list[int]) -> None:
    for _ in range(10):
        _quarter_ref(x, 0, 4, 8, 12)
        _quarter_ref(x, 1, 5, 9, 13)
        _quarter_ref(x, 2, 6, 10, 14)
        _quarter_ref(x, 3, 7, 11, 15)
        _quarter_ref(x, 0, 5, 10, 15)
        _quarter_ref(x, 1, 6, 11, 12)
        _quarter_ref(x, 2, 7, 8, 13)
        _quarter_ref(x, 3, 4, 9, 14)


def chacha20_block_ref(key: bytes, counter: int, nonce: bytes) -> bytes:
    """The 64-byte ChaCha20 block function (RFC 8439 §2.3)."""
    _check_key_nonce(key, nonce)
    state = list(_CONSTS) + _le_words(key) + [counter & _M32] + _le_words(nonce)
    x = list(state)
    _double_rounds_ref(x)
    return b"".join(((a + b) & _M32).to_bytes(4, "little") for a, b in zip(x, state))


def chacha20_xor_ref(key: bytes, nonce: bytes, data: bytes, counter: int = 1) -> bytes:
    """ChaCha20 encryption (RFC 8439 §2.4)."""
    stream = b"".join(chacha20_block_ref(key, counter + b, nonce) for b in range((len(data) + 63) // 64))
    return bytes(a ^ b for a, b in zip(data, stream))


def poly1305_ref(key32: bytes, message: bytes) -> bytes:
    """The Poly1305 tag (RFC 8439 §2.5)."""
    r = int.from_bytes(key32[:16], "little") & _CLAMP
    s = int.from_bytes(key32[16:32], "little")
    acc = 0
    for i in range(0, len(message), 16):
        block = message[i : i + 16] + b"\x01"
        acc = (acc + int.from_bytes(block, "little")) * r % _P1305
    return ((acc + s) % (1 << 128)).to_bytes(16, "little")


def poly_geometry(blocks: int, sms: int) -> tuple[int, int, int]:
    """(grid, warps, q) of csrc/chacha.cu's MAC kernel for a MAC input of
    ``blocks`` 16-byte blocks on a card of ``sms`` SMs: ``grid`` blocks of
    ``warps`` warps, each warp a span of 32 q blocks, the spans covering the
    input (leading zero blocks fill the rest). Up to ``POLY_ONE_LAUNCH``
    blocks: one block of just enough warps, which writes the tag; more: a
    persistent grid of 8-warp blocks whose partials a second launch folds."""
    if blocks <= POLY_ONE_LAUNCH:
        warps = min(POLY_WARPS, max(1, -(-blocks // 32)))
        return 1, warps, max(1, -(-blocks // (32 * warps)))
    grid = min(-(-blocks // POLY_ONE_LAUNCH), sms * POLY_BLOCKS_PER_SM)
    return grid, POLY_WARPS, -(-blocks // (32 * POLY_WARPS * grid))


def poly1305_lanes_ref(key32: bytes, message: bytes, geometry: tuple[int, int, int]) -> bytes:
    """The Poly1305 tag by the kernel's own schedule, in Python integers:
    the message's blocks (each with its 0x01 byte) lead-padded with zero
    blocks to ``grid x warps x 32 q``; lane l of each warp Horner over its
    span's blocks l, l + 32, ... with r^32; the lanes summed with the weights
    r^(31 - l), the warps of a block with (r^(32 q))^(warps - 1 - i); one
    block's sum is the polynomial, else the blocks' partials folded the same
    way, 32 lanes with the multiplier of a block's span. Equal to
    ``poly1305_ref`` for every geometry that covers the message."""
    grid, warps, q = geometry
    r = int.from_bytes(key32[:16], "little") & _CLAMP
    s = int.from_bytes(key32[16:32], "little")
    values = [int.from_bytes(message[i : i + 16] + b"\x01", "little") for i in range(0, len(message), 16)]
    span = 32 * q
    lead = grid * warps * span - len(values)
    if lead < 0:
        raise ValueError(f"geometry {geometry} covers {grid * warps * span} blocks of {len(values)}")
    values = [0] * lead + values

    def lanes(vals: list[int], m: int) -> int:  # sum_j vals[j] m^(len - 1 - j), len a multiple of 32
        m32 = pow(m, 32, _P1305)
        total = 0
        for lane in range(32):
            h = 0
            for v in vals[lane::32]:
                h = (h * m32 + v) % _P1305
            total += h * pow(m, 31 - lane, _P1305)
        return total % _P1305

    rq = pow(r, span, _P1305)
    partials = []
    for block in range(grid):
        warp_sums = [lanes(values[(block * warps + i) * span : (block * warps + i + 1) * span], r) for i in range(warps)]
        partials.append(sum(a * pow(rq, warps - 1 - i, _P1305) for i, a in enumerate(warp_sums)) % _P1305)
    if grid == 1:
        h = partials[0]
    else:
        partials = [0] * (-grid % 32) + partials
        h = lanes(partials, pow(rq, warps, _P1305))
    return ((h * r % _P1305 + s) % (1 << 128)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b + bytes(-len(b) % 16)


def _mac_data(aad: bytes, ciphertext: bytes) -> bytes:
    """The AEAD's MAC input (RFC 8439 §2.8)."""
    return _pad16(aad) + _pad16(ciphertext) + len(aad).to_bytes(8, "little") + len(ciphertext).to_bytes(8, "little")


def aead_ref(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> tuple[bytes, bytes]:
    """ChaCha20-Poly1305 seal (RFC 8439 §2.8): (ciphertext, tag)."""
    otk = chacha20_block_ref(key, 0, nonce)[:32]
    ct = chacha20_xor_ref(key, nonce, plaintext, 1)
    return ct, poly1305_ref(otk, _mac_data(aad, ct))


def _hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 subkey derivation (draft-irtf-cfrg-xchacha §2.2): 20 rounds
    over (constants, key, nonce16) with no feed-forward add; the subkey is
    words 0-3 and 12-15. Host code: one 16-word state."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("key must be 32 bytes, nonce16 16 bytes")
    x = list(_CONSTS) + _le_words(key) + _le_words(nonce16)
    _double_rounds_ref(x)
    return b"".join(w.to_bytes(4, "little") for w in x[:4] + x[12:16])


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def _check_data(data: torch.Tensor, what: str) -> None:
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"{what}: expected a 1-D uint8 tensor, got {getattr(data, 'dtype', type(data))}")


def _check_counter(counter: int) -> None:
    if not 0 <= counter <= _M32:
        raise ValueError(f"counter must be in [0, 2^32), got {counter}")


def keystream_plain(key: bytes, nonce: bytes, counter: int, blocks: int, device="cpu") -> torch.Tensor:
    """int64[blocks, 16]: the keystream words of blocks at the counters
    ``(counter + b) mod 2^32``."""
    _check_key_nonce(key, nonce)
    state = [torch.full((blocks,), w, dtype=torch.int64, device=device) for w in _CONSTS + tuple(_le_words(key))]
    state.append((torch.arange(blocks, dtype=torch.int64, device=device) + counter) & _M32)
    state += [torch.full((blocks,), w, dtype=torch.int64, device=device) for w in _le_words(nonce)]
    x = list(state)

    def quarter(a: int, b: int, c: int, d: int) -> None:
        for p, q, s, r in ((a, b, d, 16), (c, d, b, 12), (a, b, d, 8), (c, d, b, 7)):
            x[p] = (x[p] + x[q]) & _M32
            v = x[s] ^ x[p]
            x[s] = ((v << r) | (v >> (32 - r))) & _M32

    for _ in range(10):
        for a, b, c, d in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
                           (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)):
            quarter(a, b, c, d)
    return torch.stack([(v + s) & _M32 for v, s in zip(x, state)], dim=1)


def _keystream_bytes(key: bytes, nonce: bytes, counter: int, n: int, device) -> torch.Tensor:
    words = keystream_plain(key, nonce, counter, (n + 63) // 64, device)
    return torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)], dim=2).reshape(-1)[:n].to(torch.uint8)


def chacha20_xor_plain(key: bytes, nonce: bytes, data: torch.Tensor, counter: int = 1) -> torch.Tensor:
    """``data`` XOR the ChaCha20 keystream, as torch ops on data's device."""
    _check_data(data, "chacha20_xor")
    _check_counter(counter)
    return data ^ _keystream_bytes(key, nonce, counter, data.numel(), data.device)


_LIMB_BITS = 13
_LIMBS = 10
_LIMB_MASK = (1 << _LIMB_BITS) - 1


def _limbs13(value: int, device) -> torch.Tensor:
    return torch.tensor([(value >> (_LIMB_BITS * j)) & _LIMB_MASK for j in range(_LIMBS)], dtype=torch.int64, device=device)


def _block_limbs(message: torch.Tensor) -> torch.Tensor:
    """int64[blocks, 10]: each 16-byte block, with its 0x01 byte (at 16 for
    a whole block: the 2^128 bit), in 13-bit limbs."""
    n = message.numel()
    blocks = (n + 15) // 16
    padded = torch.zeros(blocks * 16 + 3, dtype=torch.int64, device=message.device)
    padded[:n] = message.to(torch.int64)
    padded[n] = 1  # the partial block's 0x01 byte, or nothing past a whole one
    b = padded[: blocks * 16].view(blocks, 16)
    full = torch.arange(1, blocks + 1, device=message.device) * 16 <= n
    tail = torch.zeros((blocks, 3), dtype=torch.int64, device=message.device)
    tail[:, 0] = full.to(torch.int64)
    b = torch.cat([b, tail], dim=1)  # bytes 16..18: the 2^128 bit, zeros
    limbs = []
    for j in range(_LIMBS):
        byte, off = divmod(_LIMB_BITS * j, 8)
        v = b[:, byte] >> off | b[:, byte + 1] << (8 - off) | b[:, byte + 2] << (16 - off)
        limbs.append(v & _LIMB_MASK)
    return torch.stack(limbs, dim=1)


def _mul_mod13(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[M, 10] * b[10] mod 2^130 - 5 in 13-bit limbs, partly carried."""
    cols = torch.zeros((a.shape[0], 2 * _LIMBS - 1), dtype=torch.int64, device=a.device)
    for i in range(_LIMBS):
        cols[:, i : i + _LIMBS] += a[:, i : i + 1] * b[None, :]
    c = cols[:, :_LIMBS].clone()
    c[:, : _LIMBS - 1] += 5 * cols[:, _LIMBS:]  # 2^130 = 5
    limbs = [c[:, j] for j in range(_LIMBS)]
    for j in range(_LIMBS - 1):
        limbs[j + 1] = limbs[j + 1] + (limbs[j] >> _LIMB_BITS)
        limbs[j] = limbs[j] & _LIMB_MASK
    limbs[0] = limbs[0] + 5 * (limbs[-1] >> _LIMB_BITS)
    limbs[-1] = limbs[-1] & _LIMB_MASK
    limbs[1] = limbs[1] + (limbs[0] >> _LIMB_BITS)
    limbs[0] = limbs[0] & _LIMB_MASK
    return torch.stack(limbs, dim=1)


def _horner_tree(v: torch.Tensor, r: int) -> int:
    """sum_i v[i] r^(n - 1 - i) mod 2^130 - 5 by a pairwise tree: each level
    pairs (v[2k], v[2k + 1]) into v[2k] * m + v[2k + 1] under the level's
    multiplier m (r, then its squares), a zero row prepended where a level
    is odd."""
    m = r
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([torch.zeros_like(v[:1]), v])
        v = _mul_mod13(v[0::2], _limbs13(m, v.device)) + v[1::2]
        m = m * m % _P1305
    return sum(int(x) << (_LIMB_BITS * j) for j, x in enumerate(v[0].tolist())) % _P1305


def poly1305_plain(key32: bytes, message: torch.Tensor) -> bytes:
    """The Poly1305 tag of ``message`` as torch ops on its device."""
    _check_data(message, "poly1305")
    if len(key32) != 32:
        raise ValueError("key32 must be 32 bytes")
    r = int.from_bytes(key32[:16], "little") & _CLAMP
    s = int.from_bytes(key32[16:32], "little")
    h = _horner_tree(_block_limbs(message), r) * r % _P1305 if message.numel() else 0
    return ((h + s) % (1 << 128)).to_bytes(16, "little")


def _mac_data_tensor(aad: bytes, ciphertext: torch.Tensor) -> torch.Tensor:
    dev = ciphertext.device
    n = ciphertext.numel()
    head = torch.tensor(list(_pad16(aad)), dtype=torch.uint8, device=dev)
    lens = len(aad).to_bytes(8, "little") + n.to_bytes(8, "little")
    tail = torch.tensor(list(bytes(-n % 16) + lens), dtype=torch.uint8, device=dev)
    return torch.cat([head, ciphertext, tail])


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def chacha20_xor_cuda(key: bytes, nonce: bytes, data: torch.Tensor, counter: int = 1) -> torch.Tensor:
    """``chacha20_xor_plain`` by the CUDA kernel: any length, any offset,
    into a new tensor on the device. Launches asynchronously."""
    _check_key_nonce(key, nonce)
    _check_counter(counter)
    build.require_cuda_bytes(data, "chacha20_xor")
    _check_data(data, "chacha20_xor")
    out = torch.empty_like(data)
    if data.numel():
        lib = build.library()
        with torch.cuda.device(data.device):
            code = lib.sw_chacha20_xor(data.data_ptr(), out.data_ptr(), data.numel(), bytes(key), bytes(nonce), counter,
                                       build.stream_of(data))
        build.check(code, "chacha20_xor")
        LAUNCHES["chacha20_xor"] += 1
    return out


def poly1305_cuda(key: torch.Tensor, message: torch.Tensor, aad: torch.Tensor | None = None) -> torch.Tensor:
    """uint8[16] on the device: the Poly1305 tag of ``message`` under the
    32-byte ``key`` (r || s, a device tensor, 4-byte aligned); with ``aad``
    (a device tensor, maybe empty), the tag of the RFC 8439 AEAD MAC input
    pad16(aad) || pad16(message) || the two lengths, read in place. One
    launch up to ``POLY_ONE_LAUNCH`` blocks of MAC input; past it, two: the
    persistent grid's partials, then their fold (``poly_geometry``)."""
    build.require_cuda_bytes(key, "poly1305 key")
    build.require_cuda_bytes(message, "poly1305")
    _check_data(message, "poly1305")
    if key.shape != (32,) or key.data_ptr() % 4 or key.device != message.device:
        raise ValueError(f"poly1305: key must be a 4-byte aligned uint8[32] on {message.device}")
    aead = aad is not None
    if aead:
        build.require_cuda_bytes(aad, "poly1305 aad")
        if aad.device != message.device:
            raise ValueError(f"poly1305: aad on {aad.device}, message on {message.device}")
    aad_len = aad.numel() if aead else 0
    blocks = -(-aad_len // 16) + -(-message.numel() // 16) + 1 if aead else -(-message.numel() // 16)
    grid, warps, q = poly_geometry(blocks, build.sm_count(message.device))
    partials = torch.empty((grid, 5), dtype=torch.int32, device=message.device) if grid > 1 else None
    tag = torch.empty(16, dtype=torch.uint8, device=message.device)
    lib = build.library()
    with torch.cuda.device(message.device):
        code = lib.sw_poly1305(
            aad.data_ptr() if aad_len else None, aad_len, message.data_ptr() if message.numel() else None,
            message.numel(), int(aead), key.data_ptr(), q, warps, grid,
            partials.data_ptr() if partials is not None else None, tag.data_ptr(), build.stream_of(message),
        )
    build.check(code, "poly1305")
    LAUNCHES["poly1305"] += 1
    return tag


# ---------------------------------------------------------------------------
# Entry points: the kernels for a CUDA tensor, the plain versions for a CPU one
# ---------------------------------------------------------------------------

def _device_of(data: torch.Tensor, what: str) -> str:
    _check_data(data, what)
    if data.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on a CUDA or CPU tensor, not {data.device}")
    return data.device.type


def chacha20_xor(key: bytes, nonce: bytes, data: torch.Tensor, counter: int = 1) -> torch.Tensor:
    """XOR ``data`` with the ChaCha20 keystream (encrypt == decrypt)."""
    if _device_of(data, "chacha20_xor") == "cuda":
        return chacha20_xor_cuda(key, nonce, data, counter)
    return chacha20_xor_plain(key, nonce, data, counter)


def poly1305_tag(key32: bytes, message: torch.Tensor) -> bytes:
    """The Poly1305 MAC (r || s = key32) of ``message``."""
    if len(key32) != 32:
        raise ValueError("key32 must be 32 bytes")
    if _device_of(message, "poly1305") == "cuda":
        key = torch.frombuffer(bytearray(key32), dtype=torch.uint8).to(message.device)
        return bytes(poly1305_cuda(key, message).cpu().tolist())
    return poly1305_plain(key32, message)


def _aad_tensor(aad: bytes, device) -> torch.Tensor:
    return torch.frombuffer(bytearray(aad), dtype=torch.uint8).to(device) if aad else torch.empty(0, dtype=torch.uint8, device=device)


def _tag_cuda(key: bytes, nonce: bytes, ciphertext: torch.Tensor, aad: bytes) -> torch.Tensor:
    """The AEAD tag on the card: the one-time key made by the keystream
    kernel (block 0) and read there by the MAC kernel."""
    otk = chacha20_xor_cuda(key, nonce, torch.zeros(64, dtype=torch.uint8, device=ciphertext.device), counter=0)
    return poly1305_cuda(otk[:32], ciphertext, _aad_tensor(aad, ciphertext.device))


def _tag_plain(key: bytes, nonce: bytes, ciphertext: torch.Tensor, aad: bytes) -> bytes:
    otk = _keystream_bytes(key, nonce, 0, 32, ciphertext.device).cpu().numpy().tobytes()
    return poly1305_plain(otk, _mac_data_tensor(aad, ciphertext))


def aead_encrypt_plain(key: bytes, nonce: bytes, plaintext: torch.Tensor, aad: bytes = b"") -> tuple[torch.Tensor, bytes]:
    """``aead_encrypt`` by the plain torch versions, on the plaintext's device."""
    _check_key_nonce(key, nonce)
    ct = chacha20_xor_plain(key, nonce, plaintext, counter=1)
    return ct, _tag_plain(key, nonce, ct, aad)


def aead_encrypt(key: bytes, nonce: bytes, plaintext: torch.Tensor, aad: bytes = b"") -> tuple[torch.Tensor, bytes]:
    """ChaCha20-Poly1305 seal: (ciphertext on the plaintext's device, 16-byte tag)."""
    _check_key_nonce(key, nonce)
    if _device_of(plaintext, "aead_encrypt") == "cpu":
        return aead_encrypt_plain(key, nonce, plaintext, aad)
    ct = chacha20_xor_cuda(key, nonce, plaintext, counter=1)
    return ct, bytes(_tag_cuda(key, nonce, ct, aad).cpu().tolist())


def aead_decrypt(key: bytes, nonce: bytes, ciphertext: torch.Tensor, tag: bytes, aad: bytes = b"") -> torch.Tensor:
    """ChaCha20-Poly1305 open: the plaintext; raises ``ValueError`` on a tag
    mismatch, before deciphering."""
    _check_key_nonce(key, nonce)
    if _device_of(ciphertext, "aead_decrypt") == "cuda":
        expect = bytes(_tag_cuda(key, nonce, ciphertext, aad).cpu().tolist())
    else:
        expect = _tag_plain(key, nonce, ciphertext, aad)
    if not hmac.compare_digest(expect, bytes(tag)):
        raise ValueError("authentication tag mismatch")
    return chacha20_xor(key, nonce, ciphertext, counter=1)


def _xchacha_subkey(key: bytes, nonce24: bytes) -> tuple[bytes, bytes]:
    _check_key_nonce(key, nonce24, 24)
    return _hchacha20(key, nonce24[:16]), bytes(4) + nonce24[16:]


def xchacha_aead_encrypt(key: bytes, nonce24: bytes, plaintext: torch.Tensor, aad: bytes = b"") -> tuple[torch.Tensor, bytes]:
    """XChaCha20-Poly1305 seal: a 192-bit nonce through the HChaCha20 subkey."""
    subkey, nonce = _xchacha_subkey(key, nonce24)
    return aead_encrypt(subkey, nonce, plaintext, aad)


def xchacha_aead_decrypt(key: bytes, nonce24: bytes, ciphertext: torch.Tensor, tag: bytes, aad: bytes = b"") -> torch.Tensor:
    """XChaCha20-Poly1305 open: raises ``ValueError`` on a tag mismatch."""
    subkey, nonce = _xchacha_subkey(key, nonce24)
    return aead_decrypt(subkey, nonce, ciphertext, tag, aad)
