"""Shared helpers of the tests that hold auto_dynamic_deeplab_torch against
auto_dynamic_deeplab_tpu: seeded numpy weights for a flax module (its tree
from ``jax.eval_shape``, so nothing is compiled to initialize it), layout
conversions and the stated tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from auto_dynamic_deeplab_torch.bridge import load_jax_variables


def flax_variables(module, *args, seed=0, **kwargs):
    """{"params", "batch_stats"} of ``module.init(key, *args, **kwargs)``
    filled from a numpy seed: kaiming-normal kernels, random biases, and
    non-trivial BN scale/bias/mean/var so that BN is really exercised; a
    supernet's "arch" (alphas, betas) standard normal, drawn after the
    rest, so that its softmaxes are far from uniform."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(tree, collection):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v, collection)
                continue
            shape = v.shape
            if collection == "batch_stats":
                a = rng.normal(0, 0.5, shape) if k == "mean" else rng.uniform(0.5, 2.0, shape)
            elif collection == "arch":
                a = rng.normal(0, 1.0, shape)
            elif k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.normal(0, np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in), shape)
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            else:  # BN, conv and dense biases
                a = rng.normal(0, 0.3, shape)
            out[k] = a.astype(np.float32)
        return out

    return {c: fill(shapes[c], c) for c in ("params", "batch_stats", "arch") if c in shapes}


def port_module(module, variables):
    """``module`` in eval mode, without gradients, with the flax
    ``variables`` loaded."""
    return load_jax_variables(module, variables).eval().requires_grad_(False)


def nchw(x_nhwc) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x_nhwc, np.float32), (0, 3, 1, 2))))


def nhwc_np(x_nchw: torch.Tensor) -> np.ndarray:
    return np.transpose(x_nchw.detach().float().numpy(), (0, 2, 3, 1))


def jx(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def assert_close_fp32_module(out, ref):
    """fp32 modules: |Δ| ≤ 1e-4·max(1, max|ref|)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol, (err, tol)


def assert_close_fp32_model(out, ref):
    """Whole-model fp32 logits: |Δ| ≤ 1e-3·max|ref| (the golden-test tolerance)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    tol = 1e-3 * float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert err <= tol, (err, tol)


def rel_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (np.abs(ref).max() + 1e-12))


def assert_bf16_within_jax(port_out, jax_bf16_out, jax_fp32_out):
    """bf16 policy: the port's max relative error against the JAX fp32
    oracle stays within 2x the JAX bf16 path's own error plus 1e-3."""
    jax_err = rel_err(jax_bf16_out, jax_fp32_out)
    port_err = rel_err(port_out, jax_fp32_out)
    assert port_err <= 2.0 * jax_err + 1e-3, (port_err, jax_err)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as cvt.rna does: to nearest, ties away from
    zero, on the 13 low mantissa bits (added to the magnitude, then masked)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def run_ranks(world: int, argv, cwd: str, timeout: float = 120.0):
    """``python *argv`` as ranks 0..world-1 of a gloo group on localhost
    (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT; one thread each), each
    waited on for ``timeout`` s; the rest are killed if one fails or
    hangs. Returns their outputs."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world))
    env["PYTHONPATH"] = cwd + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, *argv], env={**env, "RANK": str(r)}, cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs
