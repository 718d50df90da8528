"""The plain reference the benchmark holds the program to.

Plain PyTorch and NumPy only: it imports neither JAX nor anything of the
program, and takes only the benchmark's own weights, audio and batches.
"""
