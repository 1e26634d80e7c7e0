"""Embedding tables and the CUDA row kernels of dglke_tpu_torch."""
