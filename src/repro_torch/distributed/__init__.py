"""Distributed serving of the port: the page pool sharded over the ranks of
a ``distributed.mesh.PoolMesh`` (counterpart of ``repro.distributed``'s paged
part). The sharding rules for weights and activations are not yet ported:
the weights are replicated on every rank."""
