"""`dglke_tpu_torch-predict`: top-K link prediction over a saved checkpoint
(counterpart of dglke_tpu/cli/predict.py; the reference's dglke_predict).

The 7 input formats (h_r_t, h_r_*, h_*_t, *_r_t, h_*_*, *_r_*, *_*_t), 5
exec modes, raw-id translation and the same TSV output; the tables and the
scoring on the card unless --device cpu.
"""

from __future__ import annotations

import argparse

from dglke_tpu_torch.cli.args import add_device_args, warn_inert_flags
from dglke_tpu_torch.models.infer import EXEC_MODES, ScoreInfer
from dglke_tpu_torch.utils.io import load_config_json
from dglke_tpu_torch.utils.translate import (
    load_raw_triplet_data,
    load_triplet_data,
)

FORMATS = ("h_r_t", "h_r_*", "h_*_t", "*_r_t", "h_*_*", "*_r_*", "*_*_t")


def build_parser():
    p = argparse.ArgumentParser("dglke_tpu_torch-predict")
    p.add_argument("--model_path", type=str, default="ckpts")
    p.add_argument("--format", type=str, required=True, choices=FORMATS)
    p.add_argument("--data_files", type=str, default=None, nargs="+")
    p.add_argument("--raw_data", default=False, action="store_true")
    p.add_argument("--exec_mode", type=str, default="all",
                   choices=list(EXEC_MODES))
    p.add_argument("--topK", type=int, default=10)
    p.add_argument("--score_func", type=str, default="none",
                   choices=["none", "logsigmoid"])
    p.add_argument("--output", type=str, default="result.tsv")
    p.add_argument("--entity_mfile", type=str, default=None)
    p.add_argument("--rel_mfile", type=str, default=None)
    add_device_args(p)
    return p


def parse_inputs(args):
    """Map the format string to (head_f, rel_f, tail_f) file slots and load
    them: (head, rel, tail, id2e_map, id2r_map), None for a '*' slot."""
    slots = args.format.split("_")  # e.g. ['h', 'r', '*']
    files = list(args.data_files or [])
    need = [dict(h="head", r="rel", t="tail")[s] + ".list"
            for s in slots if s != "*"]
    if len(files) != len(need):
        raise ValueError(
            f"format {args.format!r} needs {len(need)} data file(s) "
            f"({', '.join(need)}); got {len(files)} via --data_files")
    head_f, rel_f, tail_f = (files.pop(0) if s != "*" else None
                             for s in slots)
    if not args.raw_data:
        return (*load_triplet_data(head_f, rel_f, tail_f), None, None)
    if args.entity_mfile is None or args.rel_mfile is None:
        raise ValueError("--raw_data needs the entity and relation mapping "
                         "files (--entity_mfile, --rel_mfile)")
    return load_raw_triplet_data(head_f=head_f, rel_f=rel_f, tail_f=tail_f,
                                 emap_f=args.entity_mfile,
                                 rmap_f=args.rel_mfile)


def main(argv=None):
    args = build_parser().parse_args(argv)
    warn_inert_flags(args)
    config = load_config_json(args.model_path)
    head, rel, tail, id2e_map, id2r_map = parse_inputs(args)

    engine = ScoreInfer(args.device, config, args.model_path,
                        args.score_func)
    engine.load_model()
    result = engine.topK(head, rel, tail, args.exec_mode, args.topK)

    with open(args.output, "w") as f:
        f.write("head\trel\ttail\tscore\n")
        for heads, rels, tails, scores in result:
            for h, r, t, s in zip(heads, rels, tails, scores):
                if args.raw_data:
                    h, r, t = id2e_map[int(h)], id2r_map[int(r)], \
                        id2e_map[int(t)]
                f.write(f"{h}\t{r}\t{t}\t{s}\n")
    print(f"Inference Done.\nThe result is saved in {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
