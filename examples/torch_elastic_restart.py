"""Fault-tolerance demo on the PyTorch/CUDA port, as
``examples/elastic_restart.py``: a training run is killed mid-flight and
resumed — the resumed loss trajectory equals an uninterrupted run's
(pure-function-of-step data + atomic checkpoints).

Run:  PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]

Trains on the card unless ``--device cpu`` is given.  Exits non-zero when
the resumed losses differ from the uninterrupted run's.
"""

import argparse
import shutil
import sys
import tempfile

from repro_torch.configs.llama32_3b import smoke
from repro_torch.ft.runtime import InjectedFailure
from repro_torch.launch.train import train


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    device = ap.parse_args(argv).device
    cfg = smoke().replace(dtype="float32", remat=False)
    kw = dict(global_batch=4, seq_len=64, ckpt_every=5, seed=0, log_every=5, device=device)
    base = tempfile.mkdtemp(prefix="elastic_")
    try:
        print("== run A: crashes after step 12 ==")
        try:
            train(cfg, steps=25, run_dir=f"{base}/a", failure_at=12, **kw)
        except InjectedFailure as e:
            print(f"   !! {e}")
        print("== run A resumed (from step-10 checkpoint) ==")
        hist_a = train(cfg, steps=25, run_dir=f"{base}/a", **kw)
        print("== run B: uninterrupted reference ==")
        hist_b = train(cfg, steps=25, run_dir=f"{base}/b", **kw)
        ref = {h["step"]: h["loss"] for h in hist_b}
        worst = max(abs(h["loss"] - ref[h["step"]]) for h in hist_a)
        print(f"\nmax |loss_resumed - loss_reference| = {worst:.2e} "
              f"({'BIT-IDENTICAL' if worst == 0 else 'check determinism'})")
        return 0 if worst == 0 else 1
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
