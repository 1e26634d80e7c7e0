"""Command-line entry points of dglke_tpu_torch."""
