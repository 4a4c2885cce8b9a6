"""Hand-written CUDA kernels for Hopper.

Layout: ``kernels/<name>/{kernel.py, ops.py, ref.py}``
  - ``kernel.py``  ctypes wrapper of ``csrc/<name>.cu`` (built by ``_build``;
                   ``histogram`` launches the kernel of ``countmin.cu``;
                   ``flash_attention``'s plain version and dispatcher
                   live in ``attention/``, as in the JAX package)
  - ``ops.py``     dispatcher: the kernel for CUDA tensors, ``ref`` for CPU
  - ``ref.py``     plain PyTorch version (CPU path, and the kernel oracle)
"""
