"""Multi-card sharding over ``torch.distributed`` (port of
:mod:`bio_ik_tpu.parallel`): :mod:`.distributed` joins the process group and
builds meshes, :mod:`.islands` shards one query's islands or a batch of
queries over a mesh axis."""
