"""Multi-device training: the process group, its collectives and the
sharding plans (counterpart of dglke_tpu/parallel/)."""
