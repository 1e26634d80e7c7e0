"""`dglke_tpu_torch-eval`: filtered full-entity evaluation of a saved
checkpoint (counterpart of dglke_tpu/cli/eval.py), single device."""

from __future__ import annotations

import argparse
import dataclasses
import os

from dglke_tpu_torch.cli.args import add_common_args, config_from_args
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import get_dataset
from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import evaluate
from dglke_tpu_torch.utils.io import load_model_state


def main(argv=None):
    parser = argparse.ArgumentParser("dglke_tpu_torch-eval")
    add_common_args(parser)
    parser.add_argument("--model_path", type=str, default="ckpts",
                        help="directory containing the saved checkpoint")
    args = parser.parse_args(argv)
    if args.neg_sample_size_eval > 0:
        raise SystemExit("--neg_sample_size_eval is not ported to "
                         "dglke_tpu_torch yet: it is ROADMAP item A8 "
                         "(sampled eval); use dglke_tpu")
    if os.path.isdir(os.path.join(args.model_path, "sharded_state")):
        raise SystemExit("sharded checkpoints are not ported to "
                         "dglke_tpu_torch yet: they are ROADMAP item A11")
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    # adopt the model's hyper-parameters from the checkpoint's config.json,
    # so that eval flags can stay minimal
    conf = os.path.join(args.model_path, "config.json")
    if os.path.exists(conf):
        saved = KGEConfig.load(conf)
        cfg = dataclasses.replace(
            cfg, model_name=saved.model_name, hidden_dim=saved.hidden_dim,
            gamma=saved.gamma, double_ent=saved.double_ent,
            double_rel=saved.double_rel, dataset=saved.dataset,
            emb_dtype=saved.emb_dtype)
    dataset = get_dataset(cfg.data_path, cfg.dataset, cfg.format,
                          cfg.delimiter, cfg.data_files,
                          cfg.has_edge_importance)
    model = KEModel(cfg, dataset.n_entities, dataset.n_relations,
                    device=device)
    state = load_model_state(cfg, model, args.model_path)
    evaluate(cfg, dataset, model, state, "test")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
