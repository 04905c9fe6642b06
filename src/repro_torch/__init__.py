"""PyTorch port of the z-SignFedAvg system (CUDA kernels for Hopper).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core``, ``kernels``, ``models``, ``optim``, ``data``, ``fed``,
``configs``, ``launch``) and never imports it. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
