"""Radial domain decomposition (the counterpart of ``scythe_tpu.parallel``):
``mesh`` (shards and their collectives, in threads of one process or over
torch.distributed), ``schur`` (the numpy builders of the distributed exact
radial solve) and ``sharding`` (the sharded step, ``initialize_sharded``
and ``integrate_sharded``)."""
