"""`dglke_tpu_torch-train`: the training CLI (counterpart of
dglke_tpu/cli/train.py).  A dataset with candidate-list splits (wikikg90M)
is validated and tested by the candidate protocol: Valid metrics during
training, top-10 predictions into test_0.pkl at the end.  With
--mix_cpu_gpu the tables live in host memory (host_table.py).

With --dist the process is one rank of a multi-device run
(parallel/mesh.py), started by torchrun or dglke_tpu_torch-dist_train:
it trains on its edge partition (--partition_path, or a split of the
dataset made in place), the tables replicated or vocab-sharded
(--table_sharding), and saves the npy checkpoint through rank 0 or, with
--sharded_ckpt, each rank's part under sharded_state/."""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from dglke_tpu_torch.cli.args import (
    add_common_args,
    add_train_args,
    config_from_args,
    refuse_unported,
    warn_inert_flags,
)
from dglke_tpu_torch.data.dataset import KGDataset, get_dataset
from dglke_tpu_torch.data.sampler import (
    EvalSampler,
    FilterIndex,
    partition_for_host,
)
from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.host_table import load_host_state
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
from dglke_tpu_torch.trainer import (
    CandidateEvalSampler,
    evaluate,
    evaluate_candidates,
    train,
)
from dglke_tpu_torch.utils.io import (
    has_sharded,
    load_model_state,
    load_sharded,
    save_model,
    save_model_dist,
    save_sharded,
)


def prepare_save_path(cfg, comm=None):
    """A fresh numbered run directory under cfg.save_path; under --dist rank
    0 counts and every rank takes its number."""
    os.makedirs(cfg.save_path, exist_ok=True)
    folder = f"{cfg.model_name}_{cfg.dataset}_"
    n = len([x for x in os.listdir(cfg.save_path) if x.startswith(folder)])
    if comm is not None:
        n = int(comm.broadcast(torch.tensor([n], dtype=torch.int64))[0])
    path = os.path.join(cfg.save_path, folder + str(n))
    os.makedirs(path, exist_ok=True)
    return dataclasses.replace(cfg, save_path=path)


def _rank_dataset(cfg, args, comm):
    """(this rank's training dataset, the whole dataset for the eval filter
    or None): the --partition_path artifacts of this rank (train edges
    only), or the dataset split over the ranks in place."""
    if args.partition_path is not None:
        from dglke_tpu_torch.data.partition_dataset import load_partition
        part = load_partition(args.partition_path, comm.rank)
        return KGDataset(name=cfg.dataset, n_entities=part.n_entities,
                         n_relations=part.n_relations, train=part.train,
                         train_partitioned=True), None
    dataset = get_dataset(cfg.data_path, cfg.dataset, cfg.format,
                          cfg.delimiter, cfg.data_files,
                          cfg.has_edge_importance)
    if comm.world == 1:
        return dataset, None
    if os.path.isdir(os.path.join(cfg.data_path, cfg.dataset,
                                  "partition_0")):
        print(f"NOTE: offline partition artifacts exist under "
              f"{os.path.join(cfg.data_path, cfg.dataset)} but "
              f"--partition_path was not given; partitioning the edge list "
              f"in place instead")
    return partition_for_host(dataset, comm.rank, comm.world,
                              rel_part=cfg.rel_part), dataset


def main(argv=None):
    parser = argparse.ArgumentParser("dglke_tpu_torch-train")
    add_common_args(parser)
    add_train_args(parser)
    args = parser.parse_args(argv)
    refuse_unported(args)
    warn_inert_flags(args)
    cfg = config_from_args(args)
    comm = init_distributed(args.device) if args.dist else None
    try:
        return _main(args, cfg, comm)
    finally:
        if comm is not None:
            comm.close()


def _main(args, cfg, comm):
    plan = None
    if comm is None:
        device = resolve_device(args.device)
    else:
        device = comm.device
        if comm.world > 1 and cfg.save_interval > 0 and \
                not cfg.no_save_emb and not args.sharded_ckpt:
            raise SystemExit(
                "--save_interval under --dist requires --sharded_ckpt (a "
                "periodic save through one rank is not kept at this scale)")
    cfg = prepare_save_path(cfg, comm)

    init_start = time.time()
    full_dataset = None   # the whole dataset, for the eval filter
    if comm is None:
        dataset = get_dataset(cfg.data_path, cfg.dataset, cfg.format,
                              cfg.delimiter, cfg.data_files,
                              cfg.has_edge_importance)
    else:
        dataset, full_dataset = _rank_dataset(cfg, args, comm)
        plan = ShardingPlan(comm, cfg.table_sharding, dataset.n_entities)
        if comm.rank == 0:
            print(plan.describe())
    print(f"|Train|: {dataset.n_train}")
    model = KEModel(cfg, dataset.n_entities, dataset.n_relations,
                    device=device, plan=plan)
    state = None
    if args.init_from and cfg.mix_cpu_gpu:
        # host-table resume: straight from the npy files into host memory
        state = load_host_state(cfg, model, args.init_from)
    elif args.init_from and has_sharded(args.init_from):
        # each rank reads its own part; another rank count is refused
        state = load_sharded(cfg, model, args.init_from)
    elif args.init_from:
        state = load_model_state(cfg, model, args.init_from)
    if state is not None:
        print(f"Resumed from {args.init_from} at step {state.step}")
    print(f"Init takes {time.time() - init_start:.3f} seconds")

    candidate_mode = (dataset.valid_dict is not None
                      or dataset.test_dict is not None)
    if cfg.mix_cpu_gpu and (
            (cfg.valid and dataset.valid_dict is not None)
            or (cfg.test and dataset.test_dict is not None)):
        # fail before step 1, not at the first eval: candidate-list eval
        # needs the table on the device, which host mode exists to avoid
        raise SystemExit(
            "--mix_cpu_gpu cannot evaluate candidate-list datasets "
            "(wikikg90M-style valid_dict/test_dict): drop --valid/--test "
            "here and evaluate the checkpoint without --mix_cpu_gpu "
            "(artifacts interchange), or on a vocab-sharded mesh")
    # Build the eval filter only when a non-candidate eval will run, and
    # never from a rank's partition: from the whole train split.
    filter_source = full_dataset or dataset
    filter_index = (FilterIndex(filter_source)
                    if cfg.eval_filter and not candidate_mode
                    and (cfg.valid or cfg.test)
                    and not filter_source.train_partitioned else None)
    # eval strides by rank over replicated tables; over a vocab-sharded
    # table every rank ranks the same batches (trainer.evaluate)
    eval_rank, eval_ranks = ((plan.rank, plan.n)
                             if plan is not None and not plan.vocab
                             else (0, 1))
    valid_samplers = None
    if cfg.valid and dataset.valid_dict is not None:
        valid_samplers = [CandidateEvalSampler(
            dataset.valid_dict, cfg.batch_size_eval, eval_rank, eval_ranks)]
    elif cfg.valid and dataset.valid is not None:
        valid_samplers = [
            EvalSampler(dataset, "valid", cfg.batch_size_eval, mode,
                        filter_index, eval_percent=cfg.eval_percent,
                        rank=eval_rank, ranks=eval_ranks, seed=cfg.seed,
                        neg_sample_size=cfg.neg_sample_size_eval,
                        neg_deg_sample=cfg.neg_deg_sample_eval)
            for mode in ("head", "tail")
        ]

    # the layout of a sharded checkpoint, in the JAX package's keys
    ckpt_meta = {"ckpt_table_sharding": cfg.table_sharding if plan
                 else "replicated", "ckpt_mesh_size": plan.n if plan else 1}
    rank0 = plan is None or plan.rank == 0

    def save(st):
        if args.sharded_ckpt:
            save_sharded(cfg, model, st, cfg.save_path)
            if rank0:
                cfg.save(cfg.save_path, dataset.emap_fname,
                         dataset.rmap_fname, **ckpt_meta)
        elif plan is not None:
            save_model_dist(cfg, model, st, emap_file=dataset.emap_fname,
                            rmap_file=dataset.rmap_fname)
        else:
            save_model(cfg, model, st, emap_file=dataset.emap_fname,
                       rmap_file=dataset.rmap_fname)

    save_fn = None
    if cfg.save_interval > 0 and not cfg.no_save_emb:
        def save_fn(st, step):
            # periodic checkpoint, overwritten in place; resume with
            # --init_from <save_path>
            save(st)
            if rank0:
                print(f"[proc 0]checkpoint at step {step} -> "
                      f"{cfg.save_path}")

    model, state, _ = train(cfg, dataset, model=model, state=state,
                            valid_samplers=valid_samplers, save_fn=save_fn,
                            plan=plan, profile_dir=args.profile)
    if not cfg.no_save_emb:
        save(state)
    if cfg.test and dataset.test_dict is not None:
        evaluate_candidates(
            model, state, CandidateEvalSampler(
                dataset.test_dict, cfg.batch_size_eval, eval_rank,
                eval_ranks),
            mode="Test", save_path=cfg.save_path, plan=plan)
    elif cfg.test and dataset.test is not None:
        evaluate(cfg, dataset, model, state, "test",
                 filter_index=filter_index, plan=plan)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
