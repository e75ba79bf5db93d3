"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref``) and the backend registry (``dispatch``).

Nothing is compiled at import: ``build`` runs ``nvcc`` at a kernel's first
launch on a CUDA tensor.
"""
