"""The Triton body of K2 (see kernels/confidence.py). Imported only by the
function that launches it, so modules that need no GPU never import triton."""
import triton
import triton.language as tl


@triton.jit
def entropy_argmax_kernel(
    x_ptr, part_ptr, arg_ptr,
    HW, C,
    stride_n, stride_p, stride_c,
    BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
):
    """One block of BLOCK_P pixels of image program_id(1): per-pixel
    entropy (summed into one partial per program) and first-max argmax."""
    pid = tl.program_id(0)
    n = tl.program_id(1)
    p = pid * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    pmask = p < HW
    mask = pmask[:, None] & (c < C)[None, :]
    ptrs = (
        x_ptr + n.to(tl.int64) * stride_n
        + (p.to(tl.int64) * stride_p)[:, None] + (c.to(tl.int64) * stride_c)[None, :]
    )
    # padded classes (and pixels past the end) are -inf: exp → 0, never argmax
    x = tl.load(ptrs, mask=mask, other=float("-inf")).to(tl.float32)
    m = tl.where(pmask, tl.max(x, axis=1), 0.0)
    s = x - m[:, None]
    e = tl.exp(s)
    z = tl.sum(e, axis=1)
    # H = -Σ p log p = log Z - Σ e·s / Z: no 0·log 0 term
    ent = tl.log(z) - tl.sum(tl.where(mask, e * s, 0.0), axis=1) / z
    ent = tl.where(pmask, ent, 0.0)
    tl.store(part_ptr + n * tl.num_programs(0) + pid, tl.sum(ent, axis=0))
    arg = tl.argmax(x, axis=1, tie_break_left=True)
    tl.store(arg_ptr + n.to(tl.int64) * HW + p, arg.to(tl.int32), mask=pmask)
