"""dglke_tpu_torch: the PyTorch/CUDA port of dglke_tpu.

The JAX package (``dglke_tpu``) stays the reference; this package runs the
same training step and full-entity eval with PyTorch, and the embedding-row
movement (row gather, row-sparse Adagrad write-back) in CUDA kernels written
for Hopper (``ops/csrc/rows.cu``).  It imports nothing of JAX or of
``dglke_tpu``.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from dglke_tpu_torch.config import KGEConfig  # noqa: F401
