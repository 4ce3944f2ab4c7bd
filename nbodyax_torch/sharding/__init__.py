"""``shards > 1``: one process a shard on ``torch.distributed``.

Counterpart of ``nbodyax/sharding``: the exact ring (``ring``), the
cell-range bh step (``bh``) and the groups and placement (``mesh``).
"""

from nbodyax_torch.sharding.bh import make_sharded_bh_step  # noqa: F401
from nbodyax_torch.sharding.mesh import (ShardGroup, close_group,  # noqa: F401
                                         make_group, maybe_init_distributed,
                                         pad_to_shards, shard_state)
from nbodyax_torch.sharding.ring import (make_sharded_step,  # noqa: F401
                                         ring_accumulators)
