"""The loops a traffic mix's ``loop`` key names (``train``).
Each gives a ``Run`` with set-up, the measured window, a profiled
sub-window, release of the program's state, and the check."""
