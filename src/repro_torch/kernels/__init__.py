"""Hand-written CUDA kernels for the checkpoint path.

* ``checksum`` — per-row Fletcher digest (storage integrity, delta detector);
* ``snapshot`` — fused per-chunk digest + dirty mask + nibble histogram.

Each subpackage has ``kernel.py`` (the CUDA wrapper, sources in ``csrc/``),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (dispatch on the
tensor's device: kernel on CUDA, plain version on the CPU).
"""
