"""Configuration for dglke_tpu_torch (counterpart of dglke_tpu/config.py).

The same flag surface as the JAX package, for the part of it this package
runs, as a plain dataclass: one config object drives the CLI, the trainer
and the config.json of a checkpoint.  The json is readable by either
package: each ignores keys that are not its fields.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional

MODEL_NAMES = (
    "TransE",
    "TransE_l1",
    "TransE_l2",
    "TransR",
    "RESCAL",
    "DistMult",
    "ComplEx",
    "RotatE",
    "SimplE",
)

LOSS_GENRES = ("Hinge", "Logistic", "Logsigmoid", "BCE")

EMB_INIT_EPS = 2.0


@dataclasses.dataclass
class KGEConfig:
    # -- model ---------------------------------------------------------------
    model_name: str = "TransE_l2"
    hidden_dim: int = 400
    gamma: float = 12.0
    double_ent: bool = False
    double_rel: bool = False

    # -- data ----------------------------------------------------------------
    data_path: str = "data"
    dataset: str = "FB15k"
    format: str = "built_in"
    data_files: Optional[List[str]] = None
    delimiter: str = "\t"
    has_edge_importance: bool = False

    # -- training ------------------------------------------------------------
    max_step: int = 80000
    batch_size: int = 1024
    neg_sample_size: int = 256
    neg_deg_sample: bool = False
    lr: float = 0.01
    regularization_coef: float = 2e-6
    regularization_norm: int = 3
    loss_genre: str = "Logsigmoid"
    neg_adversarial_sampling: bool = False
    adversarial_temperature: float = 1.0
    pairwise: bool = False
    margin: float = 1.0
    seed: int = 0

    # -- evaluation ----------------------------------------------------------
    batch_size_eval: int = 8
    neg_sample_size_eval: int = -1  # -1 => all entities
    neg_deg_sample_eval: bool = False
    eval_percent: float = 1.0
    no_eval_filter: bool = False
    save_interval: int = -1  # checkpoint every N steps (-1: only at end)
    valid: bool = False
    test: bool = False
    eval_interval: int = 10000

    # -- logging / checkpointing ---------------------------------------------
    save_path: str = "ckpts"
    no_save_emb: bool = False
    log_interval: int = 1000

    # -- storage -------------------------------------------------------------
    emb_dtype: str = "float32"  # "bfloat16" stores tables in bf16; the
    # optimizer math and the Adagrad accumulator stay fp32

    # ------------------------------------------------------------------------
    @property
    def emb_init(self) -> float:
        return (self.gamma + EMB_INIT_EPS) / self.hidden_dim

    @property
    def eval_filter(self) -> bool:
        return not self.no_eval_filter

    @property
    def neg_chunk_size(self) -> int:
        """Positives per chunk; the reference sets this to neg_sample_size
        (chunk_size == neg_sample_size when neg_sample_size < batch_size,
        else one chunk of the whole batch)."""
        if self.neg_sample_size >= self.batch_size:
            return self.batch_size
        return self.neg_sample_size

    @property
    def num_chunks(self) -> int:
        return max(1, self.batch_size // self.neg_chunk_size)

    def validate(self) -> "KGEConfig":
        if self.model_name not in MODEL_NAMES:
            raise ValueError(f"unknown model {self.model_name}")
        if self.loss_genre not in LOSS_GENRES:
            raise ValueError(f"unknown loss genre {self.loss_genre}")
        if self.pairwise and self.neg_adversarial_sampling:
            raise ValueError("pairwise loss is incompatible with adversarial "
                             "negative sampling")
        if self.pairwise and self.loss_genre not in ("Logistic", "Hinge"):
            raise ValueError(f"{self.loss_genre} loss cannot be pairwise")
        if self.emb_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown emb_dtype {self.emb_dtype}")
        if self.neg_deg_sample_eval:
            if self.eval_filter:
                raise ValueError(
                    "--neg_deg_sample_eval requires --no_eval_filter")
            if self.neg_sample_size_eval <= 0:
                raise ValueError(
                    "--neg_deg_sample_eval needs sampled eval negatives: "
                    "set --neg_sample_size_eval")
        return self

    def with_compatible_batch_size(self) -> "KGEConfig":
        """Round batch sizes up to a multiple of their neg sample size
        (reference utils.get_compatible_batch_size)."""
        bs = self.batch_size
        n = self.neg_sample_size
        if n < bs and bs % n != 0:
            bs = int(math.ceil(bs / n) * n)
        bse = self.batch_size_eval
        k = self.neg_sample_size_eval
        if 0 < k < bse and bse % k != 0:
            bse = int(math.ceil(bse / k) * k)
        return dataclasses.replace(self, batch_size=bs,
                                   batch_size_eval=bse)

    # -- config.json round trip ----------------------------------------------
    def to_json_dict(self, emap_file=None, rmap_file=None) -> dict:
        d = dataclasses.asdict(self)
        d.update({"emp_file": emap_file, "rmap_file": rmap_file})
        return d

    def save(self, path: str, emap_file=None, rmap_file=None) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.to_json_dict(emap_file, rmap_file), f, indent=4)

    @classmethod
    def load(cls, config_file: str) -> "KGEConfig":
        with open(config_file) as f:
            d = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
