"""Embedding-store backends behind one protocol (port of ``repro.store``).

  api       ``PackedBackend`` / ``HierBackend`` / ``HashedBackend``,
            ``register_backend`` / ``build`` / ``from_manifest``
  budget    the priority-driven placement planner of the hier levels
  manifest  mmap'd cold shards under the ``hier_store/v1`` manifest and
            the host dequant (``np_lookup``)
  hier      ``HierStore``: build / stage / combine / migrate across the
            device, host RAM and disk
  hashed    ``HashedStore``: ROBE-style rows materialised from a shared
            chunk pool

Every backend takes ``mesh=`` (a ``repro_torch.dist.Mesh``): the packed
store and the hier store's hot level row-sharded (``dist.packed``), the
hashed pool row-sharded (``dist.hashed``).
"""

from repro_torch.store.api import (  # noqa: F401
    HashedBackend,
    HierBackend,
    PackedBackend,
    backend_names,
    build,
    from_manifest,
    register_backend,
)
from repro_torch.store.budget import (  # noqa: F401
    COLD,
    HOT,
    WARM,
    BudgetPlan,
    hot_shard_bytes,
    plan_placement,
)
from repro_torch.store.hashed import (  # noqa: F401
    HashedConfig,
    HashedStore,
    fit_pool_from_table,
    hashed_bag_lookup,
    hashed_lookup,
    hashed_state_tree,
    init_hashed,
    plan_pool_slots,
    quantize_pool,
)
from repro_torch.store.hier import (  # noqa: F401
    HierConfig,
    HierStats,
    HierStore,
    StagedBatch,
    build_hier,
    combine_rows,
    hier_bag_lookup,
    hier_lookup,
)
from repro_torch.store.manifest import (  # noqa: F401
    ColdShards,
    np_lookup,
    write_cold_shards,
)
