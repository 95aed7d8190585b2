"""Data parallelism over torch.distributed: one process a device
(mesh.py), and the multi-process entry points (distributed.py)."""
