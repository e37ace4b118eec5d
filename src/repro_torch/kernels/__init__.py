"""Kernels of the port: the hand-written CUDA stencil+reduce sweep
(:mod:`.stencil2d`, sources in ``csrc/``), its plain PyTorch oracles and
elemental functions (:mod:`.ref`), and the §4 apps (:mod:`.ops`).
Nothing is compiled at import: the CUDA library is built at first use."""
