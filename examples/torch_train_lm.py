"""End-to-end training driver on the PyTorch/CUDA port, as
``examples/train_lm.py``: a llama-family model trained for a few hundred
steps on the synthetic Markov-token stream, with fault-tolerant
checkpointing.  Loss drops well below the unigram entropy as the model
learns the transition structure.

Default is small (~7M params).  ``--hundred-m`` trains a ~100M-param
config (same code path).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]

Trains on the card unless ``--device cpu`` is given.  Exits non-zero
when the loss is not finite.
"""

import argparse
import math
import os
import sys
import tempfile

from repro_torch.config import get_config
from repro_torch.launch.train import train
from repro_torch.optim.adamw import AdamWConfig


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--run-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_lm"))
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)

    base = get_config("llama3.2-3b")
    if args.hundred_m:  # ~100M params: 12L x 768 x 12H, 8k vocab
        cfg = base.replace(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                           head_dim=0, d_ff=2048, vocab_size=8192, remat=False)
        batch, seq = 16, 512
    else:  # the same family at a small size
        cfg = base.replace(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                           head_dim=0, d_ff=688, vocab_size=512, remat=False)
        batch, seq = 8, 128

    hist = train(
        cfg, steps=args.steps, global_batch=batch, seq_len=seq,
        run_dir=args.run_dir, ckpt_every=50, log_every=20,
        opt_cfg=AdamWConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=args.steps),
        device=args.device,
    )
    first = hist[0]["loss"]
    last = min(h["loss"] for h in hist[-10:])
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(hist)} steps "
          f"({'LEARNED' if last < first - 0.5 else 'check hyperparams'})")
    return 0 if all(math.isfinite(h["loss"]) for h in hist) else 1


if __name__ == "__main__":
    sys.exit(main())
