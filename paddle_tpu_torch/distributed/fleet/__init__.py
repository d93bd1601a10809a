"""paddle.distributed.fleet of the port.

Only `fleet.elastic` (the elastic manager and relaunch policy of the
launcher) is here. The rest of the reference's fleet (`fleet.init`,
`DistributedStrategy`, the topology and hybrid communicate group, the
meta optimizers, the tensor-parallel layers and `distributed.split`,
`meta_parallel`'s pipeline) comes with ROADMAP A.13f(ii).
"""
