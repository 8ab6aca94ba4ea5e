"""CLI: merge sharded ldasout windows into gridded files; counterpart
of ``noahmp_tpu/driver/merge.py``.

Sharded runs write ``<stamp>.nc.pLO-HI`` shard files (each covering a
slice of the land-point axis — see OutputWriter(shard=...)).  This tool
reassembles them:

    python -m noahmp_tpu_torch.driver.merge <outdir> [--delete-shards]
"""

import argparse

from .io import merge_shard_files


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("outdir", help="ldasout directory with shard files")
    p.add_argument("--delete-shards", action="store_true",
                   help="remove shard files after a successful merge")
    args = p.parse_args(argv)
    for path in merge_shard_files(args.outdir, args.delete_shards):
        print(path)


if __name__ == "__main__":
    main()
