"""The program's kernel names, grouped as the metrics read them."""

K4 = ("lstm_fwd_mma_kernel", "lstm_infer_kernel")   # LSTM training forward
K5 = ("lstm_bwd_kernel",)                           # LSTM backward
K6 = ("plane_kernel", "pack_w2_kernel")             # joint planes
K7 = ("lattice",)                                   # the loss lattice
CUBLAS = ("gemm", "Gemm", "nvjet", "xmma", "cutlass", "cublas")
NCCL = ("nccl",)
NAMED = K4 + K5 + K6 + K7 + CUBLAS + NCCL
