"""CLI argument surface -> KGEConfig (counterpart of dglke_tpu/cli/args.py).

Every flag of the JAX package's train and eval parsers parses here, plus
``--device``, and every mode it selects runs.  Flags that select nothing
are accepted and noted (``warn_inert_flags``); ``refuse_unported`` refuses
what the JAX package refuses before anything runs (--dist with
--mix_cpu_gpu).
"""

from __future__ import annotations

import argparse
import dataclasses

from dglke_tpu_torch.config import KGEConfig, LOSS_GENRES, MODEL_NAMES


def add_device_args(p: argparse.ArgumentParser, gpu_nargs=None) -> None:
    """``--device`` and the JAX package's ``--gpu``, which is accepted for
    its command lines and selects nothing: an id such as -1 does not mean
    the CPU."""
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'; without a CUDA device "
                        "the default raises instead of falling back")
    p.add_argument("--gpu", type=int, default=None, nargs=gpu_nargs,
                   help="accepted for compatibility and ignored; the device "
                        "comes from --device")


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
    p.add_argument("--num_proc", type=int, default=1)
    p.add_argument("--num_thread", type=int, default=1)
    p.add_argument("--force_sync_interval", type=int, default=-1)
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
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="training score precision: bfloat16 scores bf16 "
                        "casts of the gathered rows in the training loss "
                        "(products out in fp32); tables, gradients, the "
                        "update and eval stay fp32")
    p.add_argument("--emb_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="embedding table storage dtype (the optimizer "
                        "stays fp32)")
    p.add_argument("--table_sharding", default="replicated",
                   choices=["replicated", "vocab"],
                   help="how tables are laid out over the ranks of --dist: "
                        "whole on every rank, or the entity table's rows "
                        "cut over them")
    p.add_argument("--mix_cpu_gpu", action="store_true")
    p.add_argument("--dist", action="store_true",
                   help="one rank of a multi-device run: the process group "
                        "starts from MASTER_ADDR / MASTER_PORT / RANK / "
                        "WORLD_SIZE / LOCAL_RANK (torchrun or "
                        "dglke_tpu_torch-dist_train set them)")
    add_device_args(p, gpu_nargs="+")


def add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--valid", action="store_true")
    p.add_argument("--rel_part", action="store_true")
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
    p.add_argument("--sharded_ckpt", action="store_true",
                   help="save each rank's tables under sharded_state/ "
                        "(resume with --init_from on as many ranks)")
    p.add_argument("--partition_path", type=str, default=None,
                   help="--dist: read each rank's edges from the "
                        "dglke_tpu_torch-partition artifacts here")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace (Chrome/Perfetto "
                        "JSON, host and device) of steady-state steps into "
                        "this directory")


def refuse_unported(args: argparse.Namespace) -> None:
    """Refuse, before anything runs, what the JAX package refuses."""
    if args.dist and args.mix_cpu_gpu:
        # refused before anything runs, as the JAX package does
        raise SystemExit(
            "--mix_cpu_gpu is a single-host mode (tables live in one "
            "host's memory); combine --dist with tables on the cards "
            "(--table_sharding vocab cuts big tables over the ranks)")


def warn_inert_flags(args: argparse.Namespace, log=print) -> None:
    """One startup line per accepted-but-inert compatibility flag (the JAX
    package's NOTE lines, for what they mean on one device), so that a user
    never gets a silently different protocol."""
    if getattr(args, "gpu", None) is not None:
        log("NOTE: --gpu is a compatibility no-op — the device comes from "
            "--device (cuda unless --device cpu); no --gpu id selects the "
            "CPU")
    if getattr(args, "num_proc", 1) > 1:
        log("NOTE: --num_proc is a compatibility no-op — dglke_tpu_torch "
            "runs one process per device (--dist ranks start through "
            "torchrun or dglke_tpu_torch-dist_train)")
    if getattr(args, "force_sync_interval", -1) > 0:
        log("NOTE: --force_sync_interval is a compatibility no-op — the "
            "step is synchronous by construction")
    if getattr(args, "mix_cpu_gpu", False):
        log("NOTE: --mix_cpu_gpu keeps tables in host memory (capacity = "
            "host DRAM, throughput bounded by the host link); drop it "
            "if the tables fit in HBM")
    if getattr(args, "num_thread", 1) > 1:
        log("NOTE: --num_thread is a compatibility no-op — host sampling "
            "is vectorized numpy")
    dist = getattr(args, "dist", False)
    if getattr(args, "rel_part", False) and not dist:
        log("NOTE: --rel_part only takes effect with --dist (it selects "
            "soft relation partitioning of the edge list across hosts); "
            "single-device training uses one global sampler")
    if getattr(args, "table_sharding", "replicated") == "vocab" and not dist:
        log("NOTE: --table_sharding vocab has no effect on one device")
    if getattr(args, "partition_path", None) is not None and not dist:
        log("NOTE: --partition_path only takes effect with --dist; "
            "single-device training reads the whole dataset")


def config_from_args(args: argparse.Namespace) -> KGEConfig:
    fields = {f.name for f in dataclasses.fields(KGEConfig)}
    cfg = KGEConfig(**{k: v for k, v in vars(args).items() if k in fields})
    return cfg.with_compatible_batch_size().validate()
