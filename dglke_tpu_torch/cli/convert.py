"""`dglke_tpu_torch-convert`: raw_udd (string triple) datasets into udd
(integer id) form (counterpart of dglke_tpu/cli/convert.py; the
reference's dglke_convert).

Reads train [valid test] files of string triples, builds the id maps
(entities.tsv / relations.tsv) and writes *_id.tsv triple files in hrt or
htr order.  Runs on the host only.
"""

from __future__ import annotations

import argparse
import os
import shutil

from dglke_tpu_torch.data.dataset import load_raw_udd


def build_parser():
    p = argparse.ArgumentParser("dglke_tpu_torch-convert")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--dataset", type=str, default="udd")
    p.add_argument("--data_files", type=str, required=True, nargs="+",
                   help="train [valid test] raw triple files")
    p.add_argument("--delimiter", type=str, default="\t")
    p.add_argument("--format", "--input_format", type=str, default="hrt",
                   dest="format",
                   help="column order of the input files (hrt/htr/rht/rth/"
                        "thr/trh; 'raw_udd_{hrt}' reference spelling "
                        "accepted)")
    p.add_argument("--out_format", "--output_format", type=str,
                   default="hrt", dest="out_format",
                   help="column order of the output id files (hrt or htr; "
                        "'udd_{hrt}' reference spelling accepted)")
    p.add_argument("--output_path", type=str, default=None,
                   help="directory for the converted files "
                        "(default: data_path)")
    return p


def _order(fmt: str, valid) -> str:
    """A bare column order ('hrt') from it or from the reference's
    'raw_udd_{hrt}' / 'udd_{hrt}' spellings."""
    f = fmt.rstrip("}").rsplit("{", 1)[-1].rsplit("_", 1)[-1]
    if f not in valid:
        raise ValueError(f"bad format {fmt!r}")
    return f


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.format = _order(args.format, ("hrt", "htr", "rht", "rth",
                                       "thr", "trh"))
    args.out_format = _order(args.out_format, ("hrt", "htr"))
    ds = load_raw_udd(args.data_path, args.dataset, args.delimiter,
                      args.data_files, args.format)
    splits = {args.data_files[0]: ds.train}
    if len(args.data_files) == 3:
        splits[args.data_files[1]] = ds.valid
        splits[args.data_files[2]] = ds.test
    out_dir = args.output_path or args.data_path
    os.makedirs(out_dir, exist_ok=True)
    for fname, triples in splits.items():
        if triples is None:
            continue
        h, r, t = triples[0], triples[1], triples[2]
        base, _ = os.path.splitext(os.path.basename(fname))
        out = os.path.join(out_dir, base + "_id.tsv")
        with open(out, "w") as f:
            for i in range(len(h)):
                if args.out_format == "hrt":
                    f.write(f"{h[i]}\t{r[i]}\t{t[i]}\n")
                else:
                    f.write(f"{h[i]}\t{t[i]}\t{r[i]}\n")
        print(f"wrote {out}")
    if out_dir != args.data_path:
        for m in ("entities.tsv", "relations.tsv"):
            src = os.path.join(args.data_path, m)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, m))
    print(f"id maps written to {out_dir}/entities.tsv and relations.tsv")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
