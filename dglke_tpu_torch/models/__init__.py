"""Score functions, losses and the training/eval model of dglke_tpu_torch."""
