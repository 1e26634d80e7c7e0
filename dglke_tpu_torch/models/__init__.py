"""Score functions, losses, the training/eval model and the object-level
inference API of dglke_tpu_torch (the names dglke_tpu.models exports)."""

from dglke_tpu_torch.models.score_functions import make_score_function  # noqa: F401
from dglke_tpu_torch.models.loss import LossGenerator  # noqa: F401
from dglke_tpu_torch.models.ke_model import (  # noqa: F401
    KEModel,
    TrainState,
    metrics_from_ranks,
)
from dglke_tpu_torch.models.ge_model import (  # noqa: F401
    BasicGEModel,
    ComplExModel,
    DistMultModel,
    GNNModel,
    KGEModel,
    RESCALModel,
    RotatEModel,
    TransE_l1Model,
    TransE_l2Model,
    TransEModel,
    TransRModel,
    TripleSet,
)
