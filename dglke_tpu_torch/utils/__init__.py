"""Checkpoint I/O and state conversion of dglke_tpu_torch."""
