"""Per-layer metric readers: one file a quantity, named as the metric or
as its quantity, the metric's name before its first dot."""
