"""Fire-block kernel: the hand-written CUDA kernel and its plain PyTorch
version."""
