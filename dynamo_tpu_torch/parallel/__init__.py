"""Tensor parallelism: the split rule (mesh.py) and ranks as processes
(group.py)."""
