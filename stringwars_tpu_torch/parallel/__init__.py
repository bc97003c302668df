"""The parallel layer: device scopes, sharded placement and process groups on
``torch.distributed`` (``mesh``, ``sharding``, ``distributed``), and the
sharded pipeline step (``pipeline``)."""

from stringwars_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceScope,
    resolve_device,
    scope_variants,
    world_scope,
)
from stringwars_tpu_torch.parallel.sharding import (  # noqa: F401
    replicate,
    shard_bytes,
    shard_tokens,
)
