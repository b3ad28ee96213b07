"""Batched LM serving on the PyTorch/CUDA port, as ``examples/serve_lm.py``:
prefill a batch of prompts, decode with a KV cache, sample.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Serves on the card unless ``--device cpu`` is given.  Exits non-zero
when two greedy runs differ.
"""

import argparse
import sys
import time

import numpy as np

from repro_torch.config import get_config
from repro_torch.launch.serve import generate
from repro_torch.models.registry import build_model


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = get_config("llama3.2-3b").replace(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, head_dim=0,
        d_ff=688, vocab_size=4096, remat=False,
    )
    bundle = build_model(cfg, flash_blk=64, device=args.device)
    params = bundle.init_params(0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)

    t0 = time.time()
    out = generate(bundle, params, prompts, max_new=32, temperature=0.8)
    dt = time.time() - t0
    print(f"batch=8 prompt=64 new=32 -> {8 * 32 / dt:.1f} tok/s on {bundle.device}")
    same = bool((generate(bundle, params, prompts, max_new=8, temperature=0.0)
                 == generate(bundle, params, prompts, max_new=8, temperature=0.0)).all())
    print("greedy check:", same)
    print("sample:", out[0][:12].tolist())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
