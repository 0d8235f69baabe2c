"""Hand-written CUDA kernels for the checkpoint, fault-tolerance and LM
serving paths.

* ``checksum`` — per-row Fletcher digest (storage integrity, delta detector);
* ``snapshot`` — fused per-chunk digest + dirty mask + nibble histogram;
* ``xor_parity`` — XOR over a parity group (node-tier XOR redundancy);
* ``rs_erasure`` — GF(2^8) matrix product (node-tier RS encode/decode);
* ``flash_attention`` — blocked attention with an online softmax (prefill
  and decode);
* ``ssm_scan`` — the mamba2 (``ssd_scan``) and mamba1 (``s6_scan``)
  selective scans;
* ``lanczos`` — one three-term Lanczos step on the graphene lattice (the
  stencil matvec and its dot products, fused into three passes).

Each subpackage has ``kernel.py`` (the CUDA wrapper, sources in ``csrc/``),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (dispatch on the
tensor's device: kernel on CUDA, plain version on the CPU); ``lanczos``
has none, as ``apps/lanczos.lanczos_step`` dispatches its one caller, and
its ``ref.py`` is the plain mirror of the kernel's passes.
"""
