"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` holds one wrapper per kernel (CUDA tensor -> kernel, CPU tensor ->
``ref``), ``ref`` the plain versions, ``build`` the nvcc build and ctypes
binding of ``csrc/*.cu``, and ``bitpack`` the fixed-width bit streams the
compressed index and its two decode kernels read.
"""
