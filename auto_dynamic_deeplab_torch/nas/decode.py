"""Host-side NAS decoding (nas/decode.py of the JAX package, a NumPy copy;
the reference's Decoding/decoding_formulas.py).

β → normalized 12x4x3 transition tensor (with the 2/3 boundary-edge
correction), max-product Viterbi over the 4-level trellis, and the
top-2-edges-per-block genotype parse. No device is involved.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def network_layer_to_space(net_arch) -> np.ndarray:
    """Path (length-L levels) → one-hot (L, 4, 3) space encoding
    (decoding_formulas.py:7-24). Rate index: 0=came from above (down-move),
    1=same, 2=came from below (up-move)."""
    net_arch = [int(v) for v in net_arch]
    space = np.zeros((len(net_arch), 4, 3))
    prev = 0
    for i, layer in enumerate(net_arch):
        if i == 0:
            space[0][layer][0] = 1
        else:
            sample = {1: 0, 0: 1, -1: 2}[layer - prev]
            space[i][layer][sample] = 1
        prev = layer
    return space


def normalize_betas(betas: np.ndarray) -> np.ndarray:
    """β logits (L, 4, 3) → per-cell transition probabilities with the 2/3
    edge correction at the boundary levels (decoding_formulas.py:33-49).

    Entry [layer][level][rate] is the probability of *leaving* `level` at
    `layer` with move rate ∈ {0: down (level+1), 1: same, 2: up (level-1)}
    — matching the reference's consumption in viterbi_decode, which reads
    network_space[layer][src_level][rate].
    """
    betas = np.asarray(betas, np.float64)
    L = betas.shape[0]
    out = np.zeros((L, 4, 3))
    for layer in range(L):
        out[layer][0][1:] = _softmax(betas[layer][0][1:]) * (2 / 3)
        if layer >= 1:
            out[layer][1] = _softmax(betas[layer][1])
        if layer >= 2:
            out[layer][2] = _softmax(betas[layer][2])
        if layer >= 3:
            out[layer][3][:2] = _softmax(betas[layer][3][:2]) * (2 / 3)
    return out


def viterbi_decode(betas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Max-product DP over the trellis + backtrace (decoding_formulas.py:52-83).

    Returns (path, one_hot_space): path[i] ∈ {0..3} is the level of layer i.
    """
    space = normalize_betas(betas)
    L = space.shape[0]
    prob = np.zeros((L, 4))
    back = np.zeros((L, 4), np.int8)

    for layer in range(L):
        if layer == 0:
            prob[0][0] = space[0][0][1]
            prob[0][1] = space[0][0][2]
            back[0][0] = 0
            back[0][1] = -1
            continue
        for level in range(4):
            if layer - level < -1:
                continue
            candidates = []
            for rate in range(3):
                src = level + 1 - rate
                if (level == 0 and rate == 2) or (level == 3 and rate == 0):
                    continue
                candidates.append(prob[layer - 1][src] * space[layer][src][rate])
            prob[layer][level] = np.max(candidates)
            rate = int(np.argmax(candidates))
            back[layer][level] = (1 - rate) if level != 3 else -rate

    path = np.zeros(L, np.uint8)
    path[-1] = int(prob[-1].argmax())
    for i in range(1, L):
        path[-i - 1] = path[-i] + back[L - i, path[-i]]
    return path, network_layer_to_space(path)


def genotype_decode(alphas: np.ndarray, B: int) -> np.ndarray:
    """α logits (k, num_ops) → (2B, 2) [edge, op] rows
    (decoding_formulas.py:86-106): per block, the 2 edges with the largest
    max non-'none' softmax weight; per edge, the argmax op (may be 'none')."""
    norm = _softmax(np.asarray(alphas, np.float64), axis=-1)
    gene = []
    start, n = 0, 2
    for _ in range(B):
        end = start + n
        edges = sorted(range(start, end), key=lambda e: -np.max(norm[e, 1:]))
        for e in edges[:2]:
            gene.append([e, int(np.argmax(norm[e]))])
        start, n = end, n + 1
    return np.array(gene, np.int64)


class ArchDecoder:
    """Convenience bundle mirroring the reference's Decoder object
    (decoding_formulas.py:27)."""

    def __init__(self, alphas: Optional[np.ndarray], betas: np.ndarray, B: Optional[int] = None):
        self.alphas = alphas
        self.betas = np.asarray(betas)
        self.B = B

    def viterbi_decode(self):
        return viterbi_decode(self.betas)

    def genotype_decode(self):
        assert self.alphas is not None and self.B is not None
        return genotype_decode(self.alphas, self.B)
