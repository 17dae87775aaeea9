"""PyTorch/CUDA port of the FEDGS reproduction (paper Alg. 1 on the FEMNIST
CNN). Mirrors the layout of the JAX package (``configs``, ``data``,
``core``, ``models``, ``kernels``, ``launch``) and imports none of it: the
hot-path kernels are hand-written CUDA C++ for Hopper (``csrc/``), each with
a plain PyTorch version beside it."""
