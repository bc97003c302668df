"""Memory suite: lookup-table / generate-random / memset / memcpy / memmove
(reference ``memory/bench.rs:110-396``, defaults 1 s + 20 s, lines tokens).

The port of ``stringwars_tpu.suites.memory`` for one device, over the
corpus' bytes (default 128 MB of ``synthetic:long-lines``) on the device:

- ``lookup-table/swtorch::lut_translate<1gpu>``: the 256-byte case-invert
  table over every byte (``memops.lut_translate``: the ``lut_translate``
  kernel on a card). The JAX package's second row,
  ``lookup-table/swtpu::lut_planes``, timed its select-plane form of the
  same function (a way around the TPU's slow byte gathers); the card has
  one kernel for it, already timed by the row above, so that row is not
  ported;
- ``generate-random/swtorch::fill_random<1gpu>``: counter-based random
  bytes (Threefry-2x32, the ``threefry`` kernel), a new seed a call;
- ``memset/swtorch::fill<1gpu>``: a fill of the buffer's size with a new
  byte value a call (torch ``fill_``);
- ``memcpy/swtorch::copy<1gpu>``: a true copy of the buffer (``copy_``);
- ``memmove/swtorch::move<1gpu>``: the buffer shifted down by 8 bytes out of
  place, its tail zeroed; it counts n - 8 bytes as the reference does. (The
  JAX rows timed ``e ^ salt`` and ``roll(e, 8) ^ salt``, which no copy
  elides on its TPU; a local card runs every copy it is given.)

Under a world of N ranks (torchrun) the LUT and copy rows also run sharded
(``<Ngpu>``, the JAX package's sharded rows): each rank translates or copies
its 512-byte aligned chunk of the buffer (``sharding.shard_bytes``); work is
counted over the whole buffer. With ``--device cpu`` the rows (``<1cpu>``)
run the plain versions and torch's CPU copies. The host rows: ``bytes.translate``, ``numpy.take`` and
``numpy.PCG64``.
"""

from __future__ import annotations

import numpy as np
import torch

from stringwars_tpu_torch.ops import memops as M
from stringwars_tpu_torch.parallel.sharding import shard_bytes
from stringwars_tpu_torch.suites._common import setup_suite
from stringwars_tpu_torch.utils.harness import WorkUnits

SHIFT = 8  # the memmove rows' shift (reference memory/bench.rs:321-396)


def main(argv: list[str] | None = None):
    """Run the suite; returns its context, whose ``staged`` holds the input
    (``data``) and each row's last output (``lut``, ``fill`` with
    ``fill_value``, ``copy``, ``move``)."""
    ctx = setup_suite(
        "Memory-ops throughput (LUT, PRNG fill, set/copy/move)",
        default_tokens="lines",
        default_warmup=1.0,
        default_time=20.0,
        default_synthetic="long-lines",
        argv=argv,
    )
    n = ctx.tape.total_bytes
    data = ctx.tape.data[:n]
    dev = data.device
    lut = torch.from_numpy(M.invert_case_lut()).to(dev)
    staged = {"data": data}
    ctx.staged = staged

    def share(scope) -> torch.Tensor:
        """The scope's bytes of the buffer: all of it, or this rank's chunk."""
        return data if scope.group is None else shard_bytes(scope, data)[0]

    ctx.group("lookup-table")
    for scope in ctx.scopes:

        def lut_routine(scope=scope):
            part, key = share(scope), "lut" if scope.group is None else "lut" + scope.name

            def lut_call() -> WorkUnits:
                staged[key] = M.lut_translate(part, lut)
                return WorkUnits(1, n)

            return lut_call

        ctx.run(f"lookup-table/swtorch::lut_translate{scope.name}", "bytes", lut_routine, scope=scope)

    def host_translate():
        host, table = data.cpu().numpy().tobytes(), M.invert_case_lut().tobytes()
        return lambda: (host.translate(table), WorkUnits(1, n))[1]

    ctx.run("lookup-table/bytes.translate", "bytes", host_translate)

    def host_take():
        arr, table = data.cpu().numpy(), M.invert_case_lut()
        return lambda: (table[arr], WorkUnits(1, n))[1]

    ctx.run("lookup-table/numpy.take", "bytes", host_take)

    ctx.group("generate-random")
    seed = [0]

    def random_call() -> WorkUnits:
        seed[0] += 1
        M.fill_random_words(seed[0], n, dev)
        return WorkUnits(1, n)

    scope = ctx.scopes[0]
    ctx.run(f"generate-random/swtorch::fill_random{scope.name}", "bytes", lambda: random_call, scope=scope)
    host_rng = np.random.default_rng(42)
    ctx.run(
        "generate-random/numpy.PCG64",
        "bytes",
        lambda: lambda: (host_rng.integers(0, 256, n, dtype=np.uint8), WorkUnits(1, n))[1],
    )

    ctx.group("memset")
    staged["fill"] = torch.empty(n, dtype=torch.uint8, device=dev)
    staged["fill_value"] = 0

    def fill_call() -> WorkUnits:
        staged["fill_value"] = (staged["fill_value"] + 1) & 0xFF
        M.fill(n, staged["fill_value"], out=staged["fill"])
        return WorkUnits(1, n)

    ctx.run(f"memset/swtorch::fill{scope.name}", "bytes", lambda: fill_call, scope=scope)

    ctx.group("memcpy")
    for scope in ctx.scopes:

        def copy_routine(scope=scope):
            part = share(scope)
            out = staged["copy" if scope.group is None else "copy" + scope.name] = torch.empty_like(part)
            return lambda: (M.copy(part, out=out), WorkUnits(1, n))[1]

        ctx.run(f"memcpy/swtorch::copy{scope.name}", "bytes", copy_routine, scope=scope)

    ctx.group("memmove")
    staged["move"] = torch.empty_like(data)
    scope = ctx.scopes[0]
    ctx.run(
        f"memmove/swtorch::move{scope.name}",
        "bytes",
        lambda: lambda: (M.move(data, SHIFT, out=staged["move"]), WorkUnits(1, max(n - SHIFT, 0)))[1],
        scope=scope,
    )
    return ctx


if __name__ == "__main__":
    main()
