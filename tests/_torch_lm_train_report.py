"""The measured distances behind the LM training tests' tolerances, the
port against the JAX package on the CPU at the smoke size:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_torch_lm_train_report.py

For each LM config: the float32 loss's relative error and the worst
gradient leaf's max|d|/max|ref|; in bfloat16, the worst leaf's
max|d|/max|ref| against the reference's bfloat16 gradients, and the
global relative L2 distance of each package's bfloat16 gradients from
the float32 gradients of the same weights (their ratio is what
``check_loss_and_grads`` bounds by 2.5).  Then the train step's worst
parameter leaf after 3 steps (max|d|/max|ref|, the whole tree's L2 and
the worst leaf's update L2) and the ``lr_schedule`` steps more than 1
float32 ULP apart.
"""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_lm import ALL, smoke_pair
from _torch_lm_train import (
    flat,
    global_rel,
    port_grads,
    port_steps,
    reference_grads,
    reference_steps,
    weights,
)
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as jadamw
from repro_torch.data import TokenPipeline
from repro_torch.optim import adamw as tadamw


def worst_leaf(got: dict, ref: dict) -> float:
    return max(float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
               for k in ref if np.abs(ref[k]).max() > 0)


def grads_report(name: str) -> str:
    ref_loss, _, ref_g, _ = reference_grads(name, "float32", 0)
    loss, _, g, _ = port_grads(name, "float32", 0)
    truth = reference_grads(name, "bfloat16", 0, "float32")[2]
    _, _, ref_b, _ = reference_grads(name, "bfloat16", 0)
    _, _, got_b, _ = port_grads(name, "bfloat16", 0)
    port_l2, ref_l2 = global_rel(got_b, truth), global_rel(ref_b, truth)
    return (f"{name:24s} float32 loss {abs(loss / ref_loss - 1):.2e} grads {worst_leaf(g, ref_g):.2e}"
            f" | bfloat16 per leaf {worst_leaf(got_b, ref_b):.4f}, L2 from float32 port "
            f"{port_l2:.4f} reference {ref_l2:.4f} ratio {port_l2 / ref_l2:.2f}")


def steps_report() -> str:
    jcfg, tcfg = smoke_pair("llama3.2-3b", dtype="float32")
    tree = weights("llama3.2-3b", "float32", 4)
    pipe = TokenPipeline(tcfg.vocab_size, 4, 32, seed=4)
    batches = [pipe.batch(i) for i in range(3)]
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    out = []
    for kw in ({}, {"microbatch": 2}, {"compress": True}):
        _, ref = reference_steps(jbuild(jcfg), tree, batches, opt_kw, **kw)
        _, got = port_steps(tcfg, tree, batches, opt_kw, **kw)
        a, b, p0 = flat(got), flat(ref), flat(tree)
        upd = max(float(np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k] - p0[k])) for k in b)
        out.append(f"train step {kw or 'plain'}: params max|d|/max|ref| {worst_leaf(a, b):.2e}, "
                   f"tree L2 {global_rel(a, b):.2e}, worst leaf update L2 {upd:.2e}")
    return "\n".join(out)


def lr_report() -> str:
    cfg = tadamw.AdamWConfig()
    steps = np.concatenate([np.arange(0, 40, dtype=np.int32),
                            np.arange(40, cfg.decay_steps + 50, 97, dtype=np.int32)])
    ref = np.asarray(jadamw.lr_schedule(jadamw.AdamWConfig(), jnp.asarray(steps)))
    got = tadamw.lr_schedule(cfg, torch.from_numpy(steps)).numpy()
    ulps = np.abs(got - ref) / np.spacing(np.abs(ref))
    return f"lr_schedule: steps more than 1 ULP apart {steps[ulps > 1].tolist()} " \
           f"({ulps[ulps > 1].tolist()} ULP)"


if __name__ == "__main__":
    for name in sorted(n for n in ALL if n != "xtime-tabular"):
        print(grads_report(name), flush=True)
    print(steps_report())
    print(lr_report())
