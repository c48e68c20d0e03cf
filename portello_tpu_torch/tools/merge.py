"""Concatenate unsorted BAM shards into one BAM (raw record pass-through).

The multi-host merge path: each host writes its own unsorted output shard
(the output contract permits any order, reference docs/user_guide.md:227-230);
this tool concatenates shards under the first shard's header before the final
coordinate sort.  Headers must agree on reference sequences.
"""

from __future__ import annotations

import argparse
import sys

from portello_tpu_torch.io.bam import BamReader, BamWriter


def merge_bams(output: str, shards: list[str], n_threads: int = 1) -> int:
    writer = None
    refs = None
    n = 0
    try:
        for shard in shards:
            with BamReader(shard) as reader:
                if writer is None:
                    refs = reader.header.refs
                    dest = sys.stdout.buffer if output == "-" else output
                    level = 0 if output == "-" else 6
                    writer = BamWriter(
                        dest, reader.header, level=level, n_threads=n_threads
                    )
                elif reader.header.refs != refs:
                    raise ValueError(
                        f"Shard '{shard}' reference sequences disagree with "
                        "the first shard"
                    )
                for raw in reader.iter_raw():
                    writer.write_raw(raw)
                    n += 1
    except BaseException:
        # close (flush + EOF) then remove the incomplete destination so a
        # failed merge never leaves a truncated output at the target path
        if writer is not None:
            writer.close()
            if output != "-":
                import os

                if os.path.exists(output):
                    os.remove(output)
        raise
    if writer is not None:
        writer.close()
    return n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="portello-tpu merge")
    p.add_argument("-o", "--output", required=True, help="output BAM ('-' = stdout)")
    p.add_argument("shards", nargs="+")
    p.add_argument("--threads", type=int, default=1)
    args = p.parse_args(argv)
    n = merge_bams(args.output, args.shards, args.threads)
    print(f"merged {n} records from {len(args.shards)} shards", file=sys.stderr)


if __name__ == "__main__":
    main()
