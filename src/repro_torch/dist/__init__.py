"""The SPMD layer and the mesh: the counterparts of ``repro.dist``.

  ctx          process-global SPMD context (``repro/dist/ctx.py``): logical
               axis names resolved against a mesh; ``constrain`` checks
               ranks when configured and is an identity otherwise
  sharding     the param rulesets ("lm", "lm_ep", "recsys", "gnn"),
               ZeRO-1 specs and divisibility checks (``repro/dist/
               sharding.py``)
  collectives  split-KV decode attention over a ``Mesh``
               (``repro/dist/collectives.py``)
  mesh         ``Mesh`` / ``make_mesh`` (the counterpart of
               ``jax.make_mesh((n,), ("model",))``: N shards on one
               device, or one a device) and ``psum``
  packed       the row-sharded ``PackedStore`` (``repro/dist/packed.py``):
               ``shard_packed``, ``sharded_lookup``, ``sharded_bag_matmul``,
               ``sharded_lookup_train``, ...
  hashed       the row-sharded hashed chunk pool (``repro/dist/hashed.py``)
"""

from repro_torch.dist.mesh import Mesh, make_mesh, psum  # noqa: F401
from repro_torch.dist import collectives, ctx, sharding  # noqa: F401,E402
