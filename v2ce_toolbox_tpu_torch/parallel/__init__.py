"""Data parallelism over `torch.distributed`: one process a rank."""
