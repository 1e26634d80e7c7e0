"""`dglke_tpu_torch-partition`: split a knowledge graph's train edges into
per-rank partitions for --dist --partition_path (counterpart of
dglke_tpu/cli/partition.py; the same artifacts)."""

from __future__ import annotations

import argparse
import os

from dglke_tpu_torch.data.dataset import get_dataset
from dglke_tpu_torch.data.partition_graph import partition_and_write


def main(argv=None):
    p = argparse.ArgumentParser(
        "dglke_tpu_torch-partition",
        description="Split a knowledge graph into per-machine edge "
                    "partitions")
    p.add_argument("--data_path", type=str, default="data")
    p.add_argument("--dataset", type=str, default="FB15k")
    p.add_argument("--data_files", type=str, default=None, nargs="+")
    p.add_argument("--delimiter", type=str, default="\t")
    p.add_argument("--format", type=str, default="built_in")
    p.add_argument("-k", "--num-parts", required=True, type=int)
    p.add_argument("--method", type=str, default="ldg",
                   choices=["ldg", "random"],
                   help="ldg: streaming min-cut (METIS substitute); "
                        "random: baseline")
    args = p.parse_args(argv)

    print("load dataset..")
    dataset = get_dataset(args.data_path, args.dataset, args.format,
                          args.delimiter, args.data_files)
    print("partitioning edges...")
    prefix = os.path.join(args.data_path, args.dataset, "partition_")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    info = partition_and_write(dataset.train, dataset.n_entities,
                               dataset.n_relations, args.num_parts, prefix,
                               method=args.method)
    print(f"there are {dataset.n_train} edges in the graph and "
          f"{info['edge_cut']} edge cuts for {args.num_parts} partitions.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
