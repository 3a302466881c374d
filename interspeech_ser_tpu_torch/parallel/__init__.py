"""Multi-device helpers over ``torch.distributed``: the process-group mesh and its
collectives (``mesh``), their audit (``audit``) and tensor-parallel sharding (``tp``)."""
