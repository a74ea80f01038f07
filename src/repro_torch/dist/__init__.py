"""The mesh: row-sharded serving and training (port of the ``packed`` and
``hashed`` modules of ``repro.dist``).

  mesh    ``Mesh`` / ``make_mesh`` (the counterpart of ``jax.make_mesh``:
          N shards on one device, or one a device) and ``psum``
  packed  the row-sharded ``PackedStore``: ``shard_packed``,
          ``sharded_lookup``, ``sharded_bag_matmul``,
          ``sharded_lookup_train``, ...
  hashed  the row-sharded hashed chunk pool: ``shard_hashed``,
          ``sharded_hashed_lookup``, ``sharded_hashed_lookup_train``

The reference's ``ctx``, ``sharding`` and ``collectives`` (the LM
families' rulesets and collectives) are not ported here.
"""

from repro_torch.dist.mesh import Mesh, make_mesh, psum  # noqa: F401
