"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(ref.py) and the dispatch between them (ops.py)."""
