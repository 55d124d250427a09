"""Distribution of the port (counterpart of ``repro.distributed``).

* Training over a mesh: the sharding rules (``sharding.py``, JAX's), the
  named-axis ``mesh.TrainMesh``, the collectives with autograd
  (``collectives.py``) and the plan that carries the rules out in the
  attention families' layers (``parallel.py``: tensor parallel over
  ``model``, data parallel over ``pod`` and ``data``, FSDP); the int8
  error-feedback all-reduce (``compression.py``).
* Serving over a mesh: the same rules' serving plan
  (``parallel.ShardPlan.serving``: weights tensor-parallel over ``model``,
  the contiguous cache's batch rows, kv heads or sequence split), and the
  page pool sharded over the ``model`` axis, ``mesh.PoolMesh``
  (``paged.py``: local attention per shard, partials merged).
"""
