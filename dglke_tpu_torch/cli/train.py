"""`dglke_tpu_torch-train`: the training CLI (counterpart of
dglke_tpu/cli/train.py), single device.  A dataset with candidate-list
splits (wikikg90M) is validated and tested by the candidate protocol: Valid
metrics during training, top-10 predictions into test_0.pkl at the end.
With --mix_cpu_gpu the tables live in host memory (host_table.py)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from dglke_tpu_torch.cli.args import (
    add_common_args,
    add_train_args,
    config_from_args,
    refuse_unported,
    warn_inert_flags,
)
from dglke_tpu_torch.data.dataset import get_dataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.host_table import load_host_state
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import (
    CandidateEvalSampler,
    evaluate,
    evaluate_candidates,
    train,
)
from dglke_tpu_torch.utils.io import load_model_state, save_model


def prepare_save_path(cfg):
    """A fresh numbered run directory under cfg.save_path."""
    os.makedirs(cfg.save_path, exist_ok=True)
    folder = f"{cfg.model_name}_{cfg.dataset}_"
    n = len([x for x in os.listdir(cfg.save_path) if x.startswith(folder)])
    path = os.path.join(cfg.save_path, folder + str(n))
    os.makedirs(path, exist_ok=True)
    return dataclasses.replace(cfg, save_path=path)


def main(argv=None):
    parser = argparse.ArgumentParser("dglke_tpu_torch-train")
    add_common_args(parser)
    add_train_args(parser)
    args = parser.parse_args(argv)
    refuse_unported(args)
    warn_inert_flags(args)
    if args.init_from and os.path.isdir(os.path.join(args.init_from,
                                                     "sharded_state")):
        raise SystemExit("--init_from a sharded checkpoint is not ported to "
                         "dglke_tpu_torch yet: it is ROADMAP item A11")
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    cfg = prepare_save_path(cfg)

    init_start = time.time()
    dataset = get_dataset(cfg.data_path, cfg.dataset, cfg.format,
                          cfg.delimiter, cfg.data_files,
                          cfg.has_edge_importance)
    print(f"|Train|: {dataset.n_train}")
    model = KEModel(cfg, dataset.n_entities, dataset.n_relations,
                    device=device)
    state = None
    if args.init_from and cfg.mix_cpu_gpu:
        # host-table resume: straight from the npy files into host memory
        state = load_host_state(cfg, model, args.init_from)
        print(f"Resumed from {args.init_from} at step {state.step}")
    elif args.init_from:
        state = load_model_state(cfg, model, args.init_from)
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
    # Build the eval filter only when a non-candidate eval will run.
    filter_index = (FilterIndex(dataset)
                    if cfg.eval_filter and not candidate_mode
                    and (cfg.valid or cfg.test) else None)
    valid_samplers = None
    if cfg.valid and dataset.valid_dict is not None:
        valid_samplers = [CandidateEvalSampler(dataset.valid_dict,
                                               cfg.batch_size_eval)]
    elif cfg.valid and dataset.valid is not None:
        valid_samplers = [
            EvalSampler(dataset, "valid", cfg.batch_size_eval, mode,
                        filter_index, eval_percent=cfg.eval_percent,
                        seed=cfg.seed,
                        neg_sample_size=cfg.neg_sample_size_eval,
                        neg_deg_sample=cfg.neg_deg_sample_eval)
            for mode in ("head", "tail")
        ]

    save_fn = None
    if cfg.save_interval > 0 and not cfg.no_save_emb:
        def save_fn(st, step):
            # periodic checkpoint, overwritten in place; resume with
            # --init_from <save_path>
            save_model(cfg, model, st, emap_file=dataset.emap_fname,
                       rmap_file=dataset.rmap_fname)
            print(f"[proc 0]checkpoint at step {step} -> {cfg.save_path}")

    model, state, _ = train(cfg, dataset, model=model, state=state,
                            valid_samplers=valid_samplers, save_fn=save_fn)
    if not cfg.no_save_emb:
        save_model(cfg, model, state, emap_file=dataset.emap_fname,
                   rmap_file=dataset.rmap_fname)
    if cfg.test and dataset.test_dict is not None:
        evaluate_candidates(
            model, state, CandidateEvalSampler(dataset.test_dict,
                                               cfg.batch_size_eval),
            mode="Test", save_path=cfg.save_path)
    elif cfg.test and dataset.test is not None:
        evaluate(cfg, dataset, model, state, "test",
                 filter_index=filter_index)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
