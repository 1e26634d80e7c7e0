"""Datasets and eval-side samplers of dglke_tpu_torch."""
