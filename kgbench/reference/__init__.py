"""Plain PyTorch references of what the program computes.  Nothing here
imports the program (``dglke_tpu_torch``), ``jax`` or ``dglke_tpu``; the
references re-derive from the seed what the program derived."""
