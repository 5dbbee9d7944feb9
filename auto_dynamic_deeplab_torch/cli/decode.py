"""Decode searched β (and α) logits into a network path (and a cell
genotype): cli/decode.py of the JAX package, with the same flags and the
same .npy outputs (the reference's Decoding/decode_autodeeplab.py).

    python -m auto_dynamic_deeplab_torch.cli.decode --betas betas.npy \
        [--alphas alphas.npy --B 5] [--out-dir DIR]

Writes network_path.npy, network_path_space.npy and, with --alphas,
genotype.npy into DIR.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..nas.decode import genotype_decode, network_layer_to_space, viterbi_decode


def build_parser():
    p = argparse.ArgumentParser(description="Decode betas/alphas npy to arch")
    p.add_argument("--betas", required=True, help="betas .npy (L,4,3)")
    p.add_argument("--alphas", default=None, help="alphas .npy (k,8)")
    p.add_argument("--B", type=int, default=5)
    p.add_argument("--out-dir", default=".")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    betas = np.load(args.betas)
    path, space = viterbi_decode(betas)
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "network_path.npy"), path)
    np.save(os.path.join(args.out_dir, "network_path_space.npy"), space)
    print("network_path:", path.tolist())
    if args.alphas:
        genotype = genotype_decode(np.load(args.alphas), args.B)
        np.save(os.path.join(args.out_dir, "genotype.npy"), genotype)
        print("genotype:", genotype.tolist())
    return path


if __name__ == "__main__":
    main()
