"""Scale-out of the port: the dp x rs device mesh (``mesh``) and
multi-process runs over ``torch.distributed`` (``multihost``, ``worker``)."""
