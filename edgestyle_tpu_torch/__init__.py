"""PyTorch/CUDA port of edgestyle_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (``core/ ops/ models/
schedulers/ pipelines/ training/ data/ utils/ apps/``) plus ``kernels/``, the
hand-written CUDA kernels that replace its Pallas kernels. It imports
nothing of the JAX package.
"""
