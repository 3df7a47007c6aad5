"""Multi-rank execution: the device mesh over torch.distributed ranks."""
