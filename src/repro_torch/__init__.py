"""PyTorch and CUDA port of the dataflow fabric (the JAX package `repro` is
the reference it is held against).  Imports torch and numpy only."""
