"""The Triton body of K2 (see kernels/confidence.py). Imported only by the
function that launches it, so modules that need no GPU never import triton."""
import triton
import triton.language as tl


@triton.jit
def entropy_argmax_kernel(
    x_ptr, part_ptr, count_ptr, ent_ptr, arg_ptr,
    HW, C, stride_n, stride_p, stride_c, n_blocks, log_c,
    BLOCK_P: tl.constexpr, R_BLOCK: tl.constexpr,
):
    """Program program_id(0) of image program_id(1): walks the image's
    blocks of BLOCK_P pixels with a stride of num_programs(0); a thread
    takes its pixels' C classes one at a time, twice: the max and the
    first-max argmax, then (the block's logits now in L1) Z = Σ exp(x - m)
    and Σ exp(x - m)·(x - m), from which the entropy log Z - Σ e·s / Z is
    summed in registers. At its end the program stores that sum as its
    partial and takes a ticket from the image's counter; the program that
    takes the last ticket sums the partials in a fixed order, writes the
    image's normalized entropy and resets the counter to 0 for the next
    call."""
    pid = tl.program_id(0)
    progs = tl.num_programs(0)
    n = tl.program_id(1)
    base = x_ptr + n.to(tl.int64) * stride_n
    acc = tl.zeros([BLOCK_P], dtype=tl.float32)
    for b in range(pid, n_blocks, progs):
        p = b * BLOCK_P + tl.arange(0, BLOCK_P)
        pmask = p < HW
        ptrs = base + p.to(tl.int64) * stride_p
        m = tl.full([BLOCK_P], float("-inf"), tl.float32)
        arg = tl.zeros([BLOCK_P], dtype=tl.int32)
        for c in range(C):
            x = tl.load(ptrs + c * stride_c, mask=pmask, other=0.0).to(tl.float32)
            better = x > m  # strict: the first maximal class stays
            arg = tl.where(better, c, arg)
            m = tl.where(better, x, m)
        z = tl.zeros([BLOCK_P], dtype=tl.float32)
        t = tl.zeros([BLOCK_P], dtype=tl.float32)
        for c in range(C):
            s = tl.load(ptrs + c * stride_c, mask=pmask, other=0.0).to(tl.float32) - m
            e = tl.exp(s)
            z += e
            t += e * s
        # H = -Σ p log p = log Z - Σ e·s / Z: no 0·log 0 term
        acc += tl.where(pmask, tl.log(z) - t / z, 0.0)
        tl.store(arg_ptr + n.to(tl.int64) * HW + p, arg, mask=pmask)
    tl.store(part_ptr + n * progs + pid, tl.sum(acc, axis=0))
    # every thread's store is done before the release of the ticket
    tl.debug_barrier()
    ticket = tl.atomic_add(count_ptr + n, 1, sem="acq_rel")
    if ticket == progs - 1:
        r = tl.arange(0, R_BLOCK)
        # past L1: the partials were written by other programs
        parts = tl.load(part_ptr + n * progs + r, mask=r < progs, other=0.0, cache_modifier=".cg")
        tl.store(ent_ptr + n, tl.sum(parts, axis=0) / HW / log_c)
        tl.store(count_ptr + n, 0)
