"""Multi-process runs of the port: one process per card, over torch.distributed."""
