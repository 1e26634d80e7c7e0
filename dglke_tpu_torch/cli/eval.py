"""`dglke_tpu_torch-eval`: evaluation of a saved checkpoint (counterpart of
dglke_tpu/cli/eval.py), single device: filtered or raw ranking against all
entities or sampled negatives, or, for a dataset with a candidate-list test
split (wikikg90M), Valid metrics when it has answers and the top-10
test_0.pkl in the checkpoint directory when it has none.  A checkpoint
trained with --mix_cpu_gpu is evaluated from host memory unless
--no_mix_cpu_gpu is given.

With --dist each process is one rank (parallel/mesh.py): a sharded
checkpoint (--sharded_ckpt) is restored onto as many ranks as wrote it,
under the table sharding it records; an npy checkpoint is cut as
--table_sharding says.  Over a vocab-sharded table every rank ranks every
batch and reports the global metrics; over replicated tables each ranks
its stride."""

from __future__ import annotations

import argparse
import dataclasses
import os

from dglke_tpu_torch.cli.args import (
    add_common_args,
    config_from_args,
    refuse_unported,
    warn_inert_flags,
)
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import get_dataset
from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.host_table import load_host_state
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
from dglke_tpu_torch.trainer import (
    CandidateEvalSampler,
    evaluate,
    evaluate_candidates,
)
from dglke_tpu_torch.utils.io import (
    has_sharded,
    load_model_state,
    load_sharded,
    sharded_layout,
)


def main(argv=None):
    parser = argparse.ArgumentParser("dglke_tpu_torch-eval")
    add_common_args(parser)
    parser.add_argument("--model_path", type=str, default="ckpts",
                        help="directory containing the saved checkpoint")
    parser.add_argument("--no_mix_cpu_gpu", action="store_true",
                        help="evaluate on device-resident tables even when "
                             "the checkpoint was trained with --mix_cpu_gpu")
    args = parser.parse_args(argv)
    refuse_unported(args)
    warn_inert_flags(args)
    sharded = has_sharded(args.model_path)
    if sharded:
        # this package's format only; the JAX package's is refused by name
        layout = sharded_layout(args.model_path)
        args.table_sharding = layout["table_sharding"]
    cfg = config_from_args(args)
    comm = init_distributed(args.device) if args.dist else None
    try:
        return _main(args, cfg, comm, sharded)
    finally:
        if comm is not None:
            comm.close()


def _main(args, cfg, comm, sharded):
    device = resolve_device(args.device) if comm is None else comm.device
    # adopt the model's hyper-parameters from the checkpoint's config.json,
    # so that eval flags can stay minimal
    conf = os.path.join(args.model_path, "config.json")
    if os.path.exists(conf):
        saved = KGEConfig.load(conf)
        cfg = dataclasses.replace(
            cfg, model_name=saved.model_name, hidden_dim=saved.hidden_dim,
            gamma=saved.gamma, double_ent=saved.double_ent,
            double_rel=saved.double_rel, dataset=saved.dataset,
            emb_dtype=saved.emb_dtype,
            # a checkpoint trained with host-resident tables may be larger
            # than the card: adopt host mode from the saved config
            # (--no_mix_cpu_gpu forces the device; --mix_cpu_gpu forces
            # host mode on a checkpoint trained on the device)
            mix_cpu_gpu=(cfg.mix_cpu_gpu or saved.mix_cpu_gpu)
            and not args.no_mix_cpu_gpu)
    if comm is not None and cfg.mix_cpu_gpu:
        raise SystemExit(
            "the checkpoint was trained with --mix_cpu_gpu, a single-host "
            "mode: evaluate it without --dist, or with --no_mix_cpu_gpu")
    dataset = get_dataset(cfg.data_path, cfg.dataset, cfg.format,
                          cfg.delimiter, cfg.data_files,
                          cfg.has_edge_importance)
    plan = None
    if comm is not None:
        plan = ShardingPlan(comm, cfg.table_sharding, dataset.n_entities)
        if comm.rank == 0:
            print(plan.describe())
    if dataset.test_dict is not None and cfg.mix_cpu_gpu:
        # refuse before loading a table that may not fit on the card:
        # candidate-list eval needs the table on the device
        raise SystemExit(
            "--mix_cpu_gpu cannot evaluate candidate-list datasets "
            "(wikikg90M-style test_dict): pass --no_mix_cpu_gpu if the "
            "table fits in HBM, or evaluate on a vocab-sharded mesh")
    model = KEModel(cfg, dataset.n_entities, dataset.n_relations,
                    device=device, plan=plan)
    if cfg.mix_cpu_gpu:
        # the table stays in host memory and streams through the card
        print("Evaluating with host-resident tables (mix_cpu_gpu)")
        state = load_host_state(cfg, model, args.model_path)
        evaluate(cfg, dataset, model, state, "test")
        return 0
    state = (load_sharded(cfg, model, args.model_path) if sharded
             else load_model_state(cfg, model, args.model_path))
    if dataset.test_dict is not None:
        # strided over replicated tables; every rank ranks every query
        # over a vocab-sharded one
        strided = plan is not None and not plan.vocab
        sampler = CandidateEvalSampler(
            dataset.test_dict, cfg.batch_size_eval,
            plan.rank if strided else 0, plan.n if strided else 1)
        evaluate_candidates(
            model, state, sampler,
            mode="Valid" if sampler.ans is not None else "Test",
            save_path=args.model_path, plan=plan)
        return 0
    evaluate(cfg, dataset, model, state, "test", plan=plan)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
