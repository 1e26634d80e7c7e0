"""`dglke_tpu_torch-emb_sim`: embedding-similarity top-K (counterpart of
dglke_tpu/cli/emb_sim.py; the reference's dglke_emb_sim).

Formats: l_r (both lists), l_* (left list, all right), *_r, * (all x all);
exec modes: pairwise / all / batch_left; 5 similarity functions; the
table and the scoring on the card unless --device cpu.
"""

from __future__ import annotations

import argparse

from dglke_tpu_torch.cli.args import add_device_args, warn_inert_flags
from dglke_tpu_torch.models.infer import SIM_FUNCS, EmbSimInfer
from dglke_tpu_torch.utils.translate import (
    load_entity_data,
    load_raw_emb_data,
    load_raw_emb_mapping,
)

FORMATS = ("l_r", "l_*", "*_r", "*")


def build_parser():
    p = argparse.ArgumentParser("dglke_tpu_torch-emb_sim")
    p.add_argument("--mfile", type=str, default=None,
                   help="ID mapping file (required for --raw_data)")
    p.add_argument("--emb_file", type=str, default=None,
                   help=".npy embedding file to compute similarity over")
    p.add_argument("--format", type=str, required=True, choices=FORMATS)
    p.add_argument("--data_files", type=str, default=None, nargs="+")
    p.add_argument("--raw_data", default=False, action="store_true")
    p.add_argument("--exec_mode", type=str, default="all",
                   choices=["pairwise", "all", "batch_left"])
    p.add_argument("--topK", type=int, default=10)
    p.add_argument("--sim_func", type=str, default="cosine",
                   choices=list(SIM_FUNCS))
    p.add_argument("--output", type=str, default="result.tsv")
    add_device_args(p)
    return p


def parse_inputs(args):
    """(left ids, right ids, id2e_map) of the format; None for all."""
    files = args.data_files or []
    head = tail = id2e_map = None
    if args.format == "l_r":
        if args.raw_data:
            head, id2e_map, e2id = load_raw_emb_data(files[0],
                                                     map_f=args.mfile)
            tail, _, _ = load_raw_emb_data(files[1], e2id_map=e2id)
        else:
            head = load_entity_data(files[0])
            tail = load_entity_data(files[1])
    elif args.format == "l_*":
        if args.raw_data:
            head, id2e_map, _ = load_raw_emb_data(files[0], map_f=args.mfile)
        else:
            head = load_entity_data(files[0])
    elif args.format == "*_r":
        if args.raw_data:
            tail, id2e_map, _ = load_raw_emb_data(files[0], map_f=args.mfile)
        else:
            tail = load_entity_data(files[0])
    elif args.raw_data:
        id2e_map = load_raw_emb_mapping(map_f=args.mfile)
    return head, tail, id2e_map


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.emb_file is None:
        raise ValueError("--emb_file is required when scoring entity "
                         "embeddings")
    warn_inert_flags(args)
    head, tail, id2e_map = parse_inputs(args)

    model = EmbSimInfer(args.device, args.emb_file, args.sim_func)
    model.load_emb()
    result = model.topK(head, tail, bcast=args.exec_mode == "batch_left",
                        pair_ws=args.exec_mode == "pairwise", k=args.topK)

    with open(args.output, "w") as f:
        f.write("left\tright\tscore\n")
        for hl, tl, sl in result:
            for h, t, s in zip(hl.tolist(), tl.tolist(), sl.tolist()):
                if args.raw_data:
                    h, t = id2e_map[int(h)], id2e_map[int(t)]
                f.write(f"{h}\t{t}\t{s}\n")
    print(f"Inference Done.\nThe result is saved in {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
