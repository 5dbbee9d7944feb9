"""Stage 1, the fixed-2-exit variant (cli/search_layer.py of the JAX
package; the reference's search_layer.py), data-parallel under a process
group unless --no-dp, as cli.search. It searches the
2-exit supernets with a summed per-exit CE (loss_1 + loss_2,
search_layer.py:187-196) instead of cli.search's mean:

    --network supernet       cell+path search, exit at --exit-layer + final
    --network baseline_path  fixed cells, non-dense trellis, one fixed exit

    python -m auto_dynamic_deeplab_torch.cli.search_layer --device cpu \\
        --num-layers 4 --exit-layer 2 --F 2 --B 2 --batch-size 4 \\
        --synthetic-crop 65 65 --synthetic-length 8 --epochs 1 --alpha-epoch 0
"""
from __future__ import annotations

import argparse

from .search import add_search_args, run


def build_parser():
    p = argparse.ArgumentParser(description="NAS 2-exit supernet search (data-parallel under a process group)")
    add_search_args(p)
    p.add_argument("--network", default="baseline_path", choices=["supernet", "baseline_path"])
    p.add_argument("--exit-layer", type=int, default=5, help="the fixed early-exit station (reference default 5)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(args, args.network, (args.exit_layer,), "sum", f"search_layer_{args.network}_F{args.F}")


if __name__ == "__main__":
    main()
