"""CRAFT on PyTorch: the checkpoint/restart library of ``repro`` ported to
torch tensors and hand-written CUDA kernels for Hopper, with the LM
workload's serving path (``configs/``, ``models/``, ``launch/serve.py``).

The package mirrors ``repro``'s layout (``core/``, ``kernels/<name>/``) and
writes the same on-disk format, so a version written by either package
restores in the other.  It imports ``torch`` and numpy, never JAX.
"""
