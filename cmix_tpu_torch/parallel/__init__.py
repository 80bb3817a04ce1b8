"""dp x tp sharding on torch.distributed (``distributed``, ``mesh``) and the
multi-rank dry run (``dryrun``)."""
