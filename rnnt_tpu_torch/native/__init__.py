"""Native (C++) host components of the port, bound through ctypes:

- flac_decoder.cc   FLAC decoding (`flac.read_flac`)
- rnnt_loss_cpu.cc  the OpenMP RNN-T loss and gradient (`loss.rnnt_loss_cpu`),
                    an oracle independent of the CUDA kernels

Copies of the JAX package's sources, built by `build.py` with g++ at first
use.  Host code only: no nvcc and no kernel is involved.
"""
