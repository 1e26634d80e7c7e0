"""Loss subsystem (counterpart of dglke_tpu/models/loss.py).

  * Hinge:      max(0, margin - l * score),   l in {-1, +1}
  * Logistic:   softplus(-l * score)
  * Logsigmoid: -logsigmoid(l * score)
  * BCE:        -(l*log(sigmoid(s)) + (1-l)*log(1-sigmoid(s))), l in {0, 1}

get_total_loss:
  pairwise:  mean(L(pos - neg, +1) * w)
  pointwise: pos_loss = mean(L(pos, +1) * w)
             neg_loss = self-adversarial? sum(softmax(neg*T).detach() * Lneg, -1)
                        else mean(Lneg, -1);  then mean over batch
             loss = (pos_loss + neg_loss) / 2
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def _criterion(genre: str, margin: float):
    if genre == "Hinge":
        return lambda score, label: torch.clamp(margin - label * score,
                                                min=0.0)
    if genre == "Logistic":
        return lambda score, label: F.softplus(-label * score)
    if genre == "Logsigmoid":
        return lambda score, label: -F.logsigmoid(label * score)
    if genre == "BCE":
        # Stable form: log(1 - sigmoid(s)) == logsigmoid(-s); the direct
        # form saturates to -inf at s ~ 18 in fp32.
        return lambda score, label: -(
            label * F.logsigmoid(score)
            + (1.0 - label) * F.logsigmoid(-score))
    raise ValueError(f"loss genre {genre} is not supported")


@dataclasses.dataclass(frozen=True)
class LossGenerator:
    loss_genre: str = "Logsigmoid"
    neg_adversarial_sampling: bool = False
    adversarial_temperature: float = 1.0
    pairwise: bool = False
    margin: float = 1.0

    def __post_init__(self):
        if self.pairwise and self.neg_adversarial_sampling:
            raise ValueError("pairwise loss is incompatible with adversarial "
                             "negative sampling")
        if self.pairwise and self.loss_genre not in ("Logistic", "Hinge"):
            raise ValueError(
                f"{self.loss_genre} loss cannot be applied to pairwise loss")
        _criterion(self.loss_genre, self.margin)  # validate genre eagerly

    @property
    def neg_label(self) -> float:
        return 0.0 if self.loss_genre == "BCE" else -1.0

    def get_total_loss(self, pos_score: torch.Tensor,
                       neg_score: torch.Tensor, edge_weight=None):
        """pos_score: [B]; neg_score: [B, K] (row i holds positive i's
        scores against its chunk's K shared negatives); edge_weight:
        optional [B].  Returns (loss scalar, log dict of scalars)."""
        crit = _criterion(self.loss_genre, self.margin)
        w = 1.0 if edge_weight is None else edge_weight.reshape(-1, 1)

        if self.pairwise:
            loss = torch.mean(crit(pos_score[:, None] - neg_score, 1.0) * w)
            return loss, {"loss": loss}

        # Each positive is weighted by its own edge (the JAX package's
        # deliberate fix of the reference's [B]x[B,1] broadcast).
        pos_loss = crit(pos_score, 1.0) * (w if edge_weight is None
                                           else w[:, 0])
        neg_loss = crit(neg_score, self.neg_label) * w

        if self.neg_adversarial_sampling:
            adv = torch.softmax(
                neg_score * self.adversarial_temperature, dim=-1).detach()
            neg_loss = torch.sum(adv * neg_loss, dim=-1)
        else:
            neg_loss = torch.mean(neg_loss, dim=-1)

        neg_loss = torch.mean(neg_loss)
        pos_loss = torch.mean(pos_loss)
        loss = (pos_loss + neg_loss) / 2.0
        return loss, {"pos_loss": pos_loss, "neg_loss": neg_loss,
                      "loss": loss}


def regularization(coef: float, norm_ord: int, tensors):
    """coef * sum_i ||x_i||_p^p over the gathered rows."""
    total = 0.0
    for x in tensors:
        total = total + torch.sum(torch.abs(x) ** norm_ord)
    return coef * total
