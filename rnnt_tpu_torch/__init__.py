"""PyTorch/CUDA port of rnnt_tpu for NVIDIA Hopper (H100).

Parameters keep the JAX package's layout, and every kernel the serving path
runs is hand-written CUDA under `csrc/`, built at first CUDA use
(`kernels/build.py`).  Entry points run on the card unless the caller passes
`device="cpu"`; on CPU tensors each kernel wrapper runs its plain PyTorch
version.
"""
