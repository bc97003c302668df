"""The sharded pipeline: the multi-device end-to-end step.

The port of ``stringwars_tpu.parallel.pipeline`` (BASELINE.json's config 5:
Aho-Corasick multi-pattern counts, MinHash fingerprints and BPE over a
sharded corpus), used by ``entry.dryrun_multichip`` and the scaling suite.
Each rank of a scope runs the port's kernels on its own shard, and the four
counts are summed over the ranks by one ``all_reduce`` (the JAX step's four
``psum``\\ s); the other outputs stay sharded, as the JAX step leaves them:

- haystack rows (a chunk, then ``4 * cap + 8`` bytes of halo each): the
  substring count of one needle over the window starts each row owns
  (``p < chunk``), its windows compared across the halo (the find kernel of
  ``csrc/find.cu`` over ``row[:min(chunk + m - 1, n_cmp)]``);
- the Aho-Corasick count over the rank's chunk of the AC corpus and the
  ``max_len - 1`` bytes after it, less the matches wholly inside those
  bytes (``sharding.owned_count``): the DFA kernel of
  ``csrc/ahocorasick.cu`` in place of the TPU's one-hot matmul scan, which
  counted each lane row past its entry-state overlap;
- the rank's token rows: XXH64 digests (``csrc/hash.cu``) and their
  checksum, reduced in int64 and wrapped to 32 bits at the end; MinHash at
  ndim 32 without counts (``csrc/fingerprint.cu``); BPE over the rows
  narrowed to the shard's longest pretoken (the JAX step encodes 64-byte
  rows with ``width - 1`` iterations, and a row of length L needs at most
  L - 1, so the ids are the same): the kernel of ``csrc/bpe.cu`` takes rows
  of at most 32 bytes, a shard with a longer token takes the plain version,
  as the JAX package routes its own BPE by shape; then the ids padded back
  to the batch's width with -1; and the replicated LUT translate
  (``csrc/lut.cu``).

The inputs are staged once per rank (``stage_inputs``): the replicated
tables (needle, automaton, merges, LUT) are made from the same global
arrays on every rank, and each rank keeps only its share of the rest.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from stringwars_tpu_torch.ops import ahocorasick as AC
from stringwars_tpu_torch.ops import bpe as BPE
from stringwars_tpu_torch.ops import find as F
from stringwars_tpu_torch.ops import hash as H
from stringwars_tpu_torch.ops.fingerprint import fingerprint
from stringwars_tpu_torch.ops.memops import lut_translate
from stringwars_tpu_torch.parallel.mesh import DeviceScope
from stringwars_tpu_torch.parallel.sharding import owned_count, psum_scalar, shard_bytes, shard_tokens
from stringwars_tpu_torch.tape import PaddedTokens

NEEDLE_CAP = 4  # capacity words of the step's needle: its rows carry 4 * cap + 8 bytes of halo
AC_PATTERNS = (b"the", b"and", b"ab")
BPE_MERGES = 64  # merges trained on the first 4,000 tokens of the batch
DEMO_TOKENS_PER_CHIP = 8  # the dry run's inputs, as the JAX ``demo_inputs`` sizes them
DEMO_TOKEN_WIDTH = 64
DEMO_HAY_BYTES = 4096  # haystack bytes a device


@dataclasses.dataclass
class StepInputs:
    """One rank's inputs to the sharded step."""

    hay_rows: torch.Tensor  # uint8[R, chunk + 4 * cap + 8]: the rank's haystack rows
    needle: F.NeedleBatch  # the one needle, replicated
    tokens: PaddedTokens  # the rank's token rows
    bpe_rows: torch.Tensor  # uint8[B, bpe_width]: those rows narrowed to the shard's longest pretoken
    lut: torch.Tensor  # uint8[256], replicated
    automaton: AC.Automaton  # replicated
    ac_row: torch.Tensor  # uint8: the rank's chunk of the AC corpus and the max_len - 1 bytes after it
    ac_chunk: int
    ac_extent: int  # bytes of ac_row inside the AC corpus
    table: BPE.MergeTable  # replicated

    @property
    def bpe_route(self) -> str:
        """Where the BPE of this shard runs: ``kernel`` or ``plain``."""
        on_card = self.bpe_rows.device.type == "cuda" and self.bpe_rows.shape[1] <= BPE.KERNEL_WIDTH
        return "kernel" if on_card else "plain"


def stage_ac_rows(scope: DeviceScope, corpus, max_len: int) -> tuple[torch.Tensor, int, int]:
    """(row, chunk, extent): this rank's chunk of the AC corpus and the
    ``max_len - 1`` bytes after it (``sharding.shard_bytes``), with the
    bytes of the row that lie inside the corpus."""
    row, n, chunk = shard_bytes(scope, corpus, overlap=max_len - 1)
    return row, chunk, F.owned_extent(chunk, scope.rank * chunk, n, max_len - 1)


def stage_inputs(scope: DeviceScope, hay: np.ndarray, corpus: np.ndarray, tokens: np.ndarray, lengths: np.ndarray, *,
                 needle: bytes = b"th", ac_patterns: tuple = AC_PATTERNS) -> StepInputs:
    """This rank's ``StepInputs`` from the global arrays: ``hay`` uint8[rows,
    row_len] (rows a multiple of the scope's ranks), the AC ``corpus``,
    ``tokens`` uint8[B, W] and ``lengths`` int32[B] (B a multiple of the
    ranks). The replicated tables come from the whole arrays; the route of
    the shard's BPE goes to stderr."""
    dev = scope.device
    automaton = AC.Automaton(list(ac_patterns))
    ac_row, ac_chunk, ac_extent = stage_ac_rows(scope, corpus, automaton.max_len)
    sample = [tokens[i, : lengths[i]].tobytes() for i in range(min(len(lengths), 4000)) if lengths[i]]
    table = BPE.MergeTable.from_merges(BPE.train_merges(sample, BPE_MERGES) or [(ord("t"), ord("h"))])
    rows, _ = shard_tokens(scope, hay)
    data, _ = shard_tokens(scope, tokens)
    lens, _ = shard_tokens(scope, np.asarray(lengths, np.int32))
    width = max(int(lens.max()) if lens.numel() else 1, 1)
    inputs = StepInputs(
        hay_rows=rows,
        needle=F.NeedleBatch.from_needles([F.pack_needle(needle, NEEDLE_CAP)], dev),
        tokens=PaddedTokens(data=data, lengths=lens, width=data.shape[1]),
        bpe_rows=data[:, :width].contiguous(),
        lut=torch.from_numpy(np.arange(256, dtype=np.uint8)[::-1].copy()).to(dev),
        automaton=automaton,
        ac_row=ac_row,
        ac_chunk=ac_chunk,
        ac_extent=ac_extent,
        table=table,
    )
    print(f"pipeline {scope.name} rank {scope.rank}: BPE over rows of {width} B (the shard's longest pretoken): "
          f"{inputs.bpe_route}", file=sys.stderr, flush=True)
    return inputs


def demo_arrays(chips: int):
    """(hay, corpus, tokens, lengths): the dry run's small global inputs for
    ``chips`` devices, the ``default_rng(0)`` draws of the JAX package's
    ``demo_inputs``: one random a/b haystack row a device, the AC corpus the
    rows' chunks end to end, and random lowercase tokens."""
    rng = np.random.default_rng(0)
    row_len = DEMO_HAY_BYTES + 4 * NEEDLE_CAP + 8
    hay = rng.integers(97, 99, (chips, row_len), dtype=np.uint8)  # 'a'/'b' soup
    tokens = rng.integers(97, 123, (chips * DEMO_TOKENS_PER_CHIP, DEMO_TOKEN_WIDTH), dtype=np.uint8)
    lengths = rng.integers(1, DEMO_TOKEN_WIDTH, chips * DEMO_TOKENS_PER_CHIP, dtype=np.int32)
    return hay, hay[:, :DEMO_HAY_BYTES].reshape(-1), tokens, lengths


def demo_inputs(scope: DeviceScope, chips: int | None = None) -> StepInputs:
    """This rank's share of ``demo_arrays(chips)`` (default: the scope's
    ranks), the needle ``ab``."""
    hay, corpus, tokens, lengths = demo_arrays(scope.gpus if chips is None else chips)
    return stage_inputs(scope, hay, corpus, tokens, lengths, needle=b"ab")


def _local_step(inputs: StepInputs, scope: DeviceScope) -> dict[str, torch.Tensor]:
    """The step on this rank's shard, then one ``all_reduce`` of the counts."""
    row_len = inputs.hay_rows.shape[1]
    chunk = row_len - 4 * NEEDLE_CAP - 8
    n_cmp = row_len - (4 * NEEDLE_CAP - 4)  # the JAX step compares windows of the longest needle the capacity holds
    n_local = min(chunk + inputs.needle.host_lengths[0] - 1, n_cmp)
    matches = sum(F.find_counts(row, inputs.needle, n_local)[0] for row in inputs.hay_rows)
    ac = owned_count(lambda hay, n: AC.ac_count_tensor(inputs.automaton, hay, n)[0], inputs.ac_row, inputs.ac_chunk,
                     inputs.ac_extent)
    digests = H.xxh64(inputs.tokens).view(torch.int64)
    lo = digests & 0xFFFFFFFF
    checksum = lo.sum() + ((digests >> 32) & 0xFFFFFFFF).sum()
    minhash, _ = fingerprint(inputs.tokens, ndim=32, with_counts=False)
    ids, counts = BPE.bpe_encode(inputs.bpe_rows, inputs.tokens.lengths, inputs.table)
    ids = torch.nn.functional.pad(ids, (0, inputs.tokens.width - ids.shape[1]), value=-1)
    translated = lut_translate(inputs.tokens.data, inputs.lut)
    totals = psum_scalar(torch.stack([matches, ac, checksum, counts.sum(dtype=torch.int64)]), scope)
    return {
        "matches": totals[0],
        "ac_matches": totals[1],
        "digest_checksum": totals[2] & 0xFFFFFFFF,
        "bpe_tokens": totals[3],
        "digests_lo": lo,
        "minhash": minhash,
        "bpe_ids": ids,
        "translated": translated,
    }


def make_sharded_step(scope: DeviceScope):
    """The step over ``scope``: ``step(inputs)`` returns the reduced counts
    (0-d int64 tensors: ``matches``, ``ac_matches``, ``digest_checksum``
    (mod 2^32), ``bpe_tokens``) and this rank's rows of ``digests_lo``
    (int64, the digests' low 32 bits), ``minhash`` (uint32[B, 32]),
    ``bpe_ids`` (int32[B, W], -1 padded) and ``translated``."""
    return lambda inputs: _local_step(inputs, scope)

