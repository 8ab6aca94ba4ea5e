"""Scale-out over the land-point axis (``torch.distributed`` ranks, one
device each) and sharded checkpoints; counterpart of
``noahmp_tpu/dist/``."""
