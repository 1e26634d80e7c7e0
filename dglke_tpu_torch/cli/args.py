"""CLI argument surface -> KGEConfig (counterpart of dglke_tpu/cli/args.py).

The same flag names as the JAX package for what this package runs, plus
``--device``.  Flags of modes not ported yet are accepted and refused with
the ROADMAP item that will bring them.
"""

from __future__ import annotations

import argparse
import dataclasses

from dglke_tpu_torch.config import KGEConfig, LOSS_GENRES, MODEL_NAMES


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_name", default="TransE",
                   choices=list(MODEL_NAMES))
    p.add_argument("--data_path", type=str, default="data")
    p.add_argument("--dataset", type=str, default="FB15k")
    p.add_argument("--format", type=str, default="built_in")
    p.add_argument("--data_files", type=str, default=None, nargs="+")
    p.add_argument("--delimiter", type=str, default="\t")
    p.add_argument("--save_path", type=str, default="ckpts")
    p.add_argument("--no_save_emb", action="store_true")
    p.add_argument("--max_step", type=int, default=80000)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--batch_size_eval", type=int, default=8)
    p.add_argument("--neg_sample_size", type=int, default=256)
    p.add_argument("--neg_deg_sample", action="store_true")
    p.add_argument("--neg_deg_sample_eval", action="store_true")
    p.add_argument("--neg_sample_size_eval", type=int, default=-1)
    p.add_argument("--eval_percent", type=float, default=1.0)
    p.add_argument("--no_eval_filter", action="store_true")
    p.add_argument("-log", "--log_interval", type=int, default=1000)
    p.add_argument("--eval_interval", type=int, default=10000)
    p.add_argument("--test", action="store_true")
    p.add_argument("--hidden_dim", type=int, default=400)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("-g", "--gamma", type=float, default=12.0)
    p.add_argument("-de", "--double_ent", action="store_true")
    p.add_argument("-dr", "--double_rel", action="store_true")
    p.add_argument("-adv", "--neg_adversarial_sampling", action="store_true")
    p.add_argument("-a", "--adversarial_temperature", default=1.0,
                   type=float)
    p.add_argument("-rc", "--regularization_coef", type=float, default=2e-6)
    p.add_argument("-rn", "--regularization_norm", type=int, default=3)
    p.add_argument("-pw", "--pairwise", action="store_true")
    p.add_argument("--loss_genre", default="Logsigmoid",
                   choices=list(LOSS_GENRES))
    p.add_argument("-m", "--margin", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--has_edge_importance", action="store_true")
    p.add_argument("--emb_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="embedding table storage dtype (the optimizer "
                        "stays fp32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'; without a CUDA device "
                        "the default raises instead of falling back")


def add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--valid", action="store_true")
    p.add_argument("--init_from", type=str, default=None,
                   help="resume training from a saved checkpoint directory "
                        "(tables + Adagrad state + step)")
    p.add_argument("--save_interval", type=int, default=-1,
                   help="checkpoint every N steps during training (-1 = "
                        "only at the end)")
    p.add_argument("--async_update", action="store_true",
                   help="defer each step's entity update by one step inside "
                        "a group of steps (deterministic form of the "
                        "reference's async updater; rows scored one step "
                        "stale)")
    # Accepted for the JAX package's command lines; refused below.
    p.add_argument("--mix_cpu_gpu", action="store_true")
    p.add_argument("--dist", action="store_true")
    p.add_argument("--sharded_ckpt", action="store_true")


# flag -> (is it set?, ROADMAP item that ports it)
_UNPORTED = {
    "--mix_cpu_gpu": (lambda a: a.mix_cpu_gpu,
                      "A10 (host-resident tables, host_table.py)"),
    "--dist": (lambda a: a.dist, "A11 (multi-device)"),
    "--sharded_ckpt": (lambda a: a.sharded_ckpt,
                       "A11 (sharded checkpoints)"),
}


def refuse_unported(args: argparse.Namespace) -> None:
    for flag, (is_set, item) in _UNPORTED.items():
        if is_set(args):
            raise SystemExit(f"{flag} is not ported to dglke_tpu_torch yet: "
                             f"it is ROADMAP item {item}; use dglke_tpu")


def config_from_args(args: argparse.Namespace) -> KGEConfig:
    fields = {f.name for f in dataclasses.fields(KGEConfig)}
    cfg = KGEConfig(**{k: v for k, v in vars(args).items() if k in fields})
    return cfg.with_compatible_batch_size().validate()
