"""Distribution of the port (counterpart of ``repro.distributed``).

* Training over a mesh: the sharding rules (``sharding.py``, JAX's), the
  named-axis ``mesh.TrainMesh``, the collectives with autograd
  (``collectives.py``) and the plan that carries the rules out in the
  attention families' layers (``parallel.py``: tensor parallel over
  ``model``, data parallel over ``pod`` and ``data``, FSDP); the int8
  error-feedback all-reduce (``compression.py``).
* Distributed paged serving: the page pool sharded over the ranks of a
  ``mesh.PoolMesh`` (``paged.py``), every rank holding all the weights.
"""
