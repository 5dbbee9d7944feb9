"""Time the flagship ASPP's dilated 3x3 convs (400 -> 256 channels at 65x129,
dilation 6/12/18, the shapes of the 1025x2049 flagship head) on the GPU in
several forms: F.conv2d on channels_last and on contiguous NCHW inputs,
with and without cudnn.benchmark, and the JAX package's shifted form
(one 1x1 matmul to the 9 taps, then 9 shifted adds). Prints one JSON line
per form and dtype with the median CUDA-event time over 20 calls.

    python scripts/torch_probe_dilated_conv.py
"""
from __future__ import annotations

import json
import statistics

import torch
import torch.nn.functional as F


def cuda_ms(fn, runs=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def shifted(x, w, d):
    """3x3 conv at dilation d (padding d) as one matmul + 9 shifted adds."""
    n, c, h, wd = x.shape
    taps = torch.einsum("nchw,kcij->nijkhw", x, w)  # (N, 3, 3, K, H, W)
    out = torch.zeros(n, w.shape[0], h, wd, device=x.device, dtype=torch.float32)
    for i in range(3):
        for j in range(3):
            dh, dw = (i - 1) * d, (j - 1) * d
            if abs(dh) >= h or abs(dw) >= wd:
                continue
            ys, ye = max(0, -dh), min(h, h - dh)
            xs, xe = max(0, -dw), min(wd, wd - dw)
            out[:, :, ys:ye, xs:xe] += taps[:, i, j, :, ys + dh:ye + dh, xs + dw:xe + dw].float()
    return out.to(x.dtype)


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1, 400, 65, 129, device="cuda", generator=g).to(dtype)
        w = (torch.randn(256, 400, 3, 3, device="cuda", generator=g) * 0.02).to(dtype)
        for d in (6, 12, 18):
            row = {"dtype": str(dtype).split(".")[-1], "dilation": d, "device": torch.cuda.get_device_name(0)}
            ref = F.conv2d(x.float(), w.float(), padding=d, dilation=d)
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                for fmt in ("channels_last", "nchw"):
                    xi = x.contiguous(memory_format=torch.channels_last) if fmt == "channels_last" else x.contiguous()
                    wi = w.contiguous(memory_format=torch.channels_last) if fmt == "channels_last" else w.contiguous()
                    row[f"conv_{fmt}{'_benchmark' if bench else ''}_ms"] = cuda_ms(
                        lambda: F.conv2d(xi, wi, padding=d, dilation=d))
            torch.backends.cudnn.benchmark = False
            row["shifted_ms"] = cuda_ms(lambda: shifted(x, w, d))
            err = (shifted(x, w, d).float() - ref).abs().max().item()
            row["shifted_max_abs_err"] = err
            row["ref_max_abs"] = ref.abs().max().item()
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
