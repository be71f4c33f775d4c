"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

The port is a package of its own: it imports ``torch``, numpy and the
standard library, never ``jax`` and never a module of ``repro``. Module
paths mirror the JAX package (``configs``, ``models``, ``kernels``,
``core``, ``optim``, ``data``, ``launch``) so each module's counterpart is
easy to find. Every Pallas kernel on a ported path becomes a CUDA C++
kernel under ``csrc/``, built for ``sm_90a`` at first use.
"""
