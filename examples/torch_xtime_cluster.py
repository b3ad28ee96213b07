"""X-TIME behind an elastic serving CLUSTER on the PyTorch/CUDA port, step
for step as ``examples/xtime_cluster.py``: two models are compiled once
(``repro_torch.build``) and replicated onto a 2-replica ``ClusterServer``;
a seeded heavy-tailed traffic trace (``make_trace``) replays against it
with a 'kill' mark half-way — replica 0 dies mid-traffic, the heartbeat
monitor re-routes its queued work to the survivor, throughput degrades
but every accepted request still completes with predictions BIT-EQUAL to
a fresh single-replica pass over the same rows.  ``restore_replica``
then brings the dead slot back (elastic restart) and a second replay
shows the rotation healed (DESIGN.md §12).

Run:  PYTHONPATH=src python examples/torch_xtime_cluster.py [--device cpu]

The replicas serve on the card unless ``--device cpu`` is given.  Exits
non-zero when a request's result differs from the direct engine's, or the
restored replica takes no traffic.
"""

import argparse
import sys

import numpy as np

from repro_torch import ClusterServer, build
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import GBDTParams, train_gbdt
from repro_torch.data.tabular import make_dataset
from repro_torch.serve import make_trace, replay_trace


def _train(name: str, n_rounds: int = 25):
    ds = make_dataset(name)
    quant = FeatureQuantizer.fit(ds.x_train, 256)
    ens = train_gbdt(
        quant.transform(ds.x_train), ds.y_train, task=ds.task, n_bins=256,
        n_classes=ds.n_classes,
        params=GBDTParams(n_rounds=n_rounds, max_leaves=64),
    )
    return quant.transform(ds.x_test).astype(np.int32), build(ens)


def _replica_line(report: dict) -> str:
    return "  ".join(
        f"replica {rid}: {r['state']:8s} {r['served_requests']:4d} req "
        f"{r['flushes']:3d} flushes"
        for rid, r in sorted(report["replicas"].items())
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the replicas serve (default: the card)")
    device = ap.parse_args(argv).device

    print("[build] compiling two models once (artifacts replicate as-is)")
    streams, artifacts = {}, {}
    for name in ("churn", "telco"):
        streams[name], artifacts[name] = _train(name)
        print(f"[build]    {name:6s} {artifacts[name].table.n_rows} CAM rows")

    trace = make_trace(
        list(streams), 600, seed=7, mean_interval_s=5e-4, mean_rows=1.5,
        marks=[(0.5, "kill")],
    )
    print(f"[trace] {len(trace.requests)} requests / {trace.n_rows} rows, "
          f"seed={trace.seed}, kill mark at t={trace.marks[0].t * 1e3:.1f}ms")

    with ClusterServer(
        n_replicas=2, device=device, flush_rows=64, max_batch=128,
        heartbeat_timeout_s=5.0,
    ) as srv:
        for name, art in artifacts.items():
            entry = srv.register(name, art)
            print(f"[register] {name:6s} v{entry.version} on 2 replicas "
                  "(compile once, install twice)")

        # warm the coalescing buckets, then zero the SLO window
        replay_trace(srv.submit, trace, streams, speed=0)
        srv.drain(timeout=300)
        srv.reset_stats()

        print("\n[replay] burst replay with replica 0 killed half-way:")
        res = replay_trace(
            srv.submit, trace, streams, speed=0,
            callbacks={"kill": lambda: srv.kill_replica(0)},
        )
        srv.drain(timeout=300)
        rep = srv.report()
        m = rep["measured"]
        print(f"  completed {m['requests']}/{res.submitted} requests, "
              f"{rep['failovers']} failover(s), shed={sum(rep['shed'].values())}")
        print(f"  p50={m['p50_ms']:.1f}ms p99={m['p99_ms']:.1f}ms "
              f"{m['requests_per_s']:,.0f} req/s (degraded: one survivor)")
        print(f"  {_replica_line(rep)}")

        # correctness survived the failover: every handle matches a direct
        # single-replica pass over the same replayed rows
        checked = 0
        for h, req in zip(res.handles, trace.requests):
            rows = np.take(
                streams[req.model],
                np.arange(req.row_start, req.row_start + req.n_rows),
                axis=0, mode="wrap",
            )
            eng = artifacts[req.model].engine(device)
            if np.array_equal(h.result(30), eng.predict(rows).cpu().numpy()):
                checked += 1
        print(f"  bit-equality: {checked}/{len(res.handles)} requests match "
              "the direct engine — failover lost nothing")

        print("\n[restore] elastic restart of the dead slot:")
        srv.restore_replica(0)
        srv.reset_stats()
        replay_trace(srv.submit, trace, streams, speed=0)
        srv.drain(timeout=300)
        rep = srv.report()
        m = rep["measured"]
        print(f"  {_replica_line(rep)}")
        print(f"  p50={m['p50_ms']:.1f}ms p99={m['p99_ms']:.1f}ms "
              f"{m['requests_per_s']:,.0f} req/s (both replicas serving)")
        restored = rep["replicas"][0]
    failures = []
    if checked != len(res.handles):
        failures.append(f"{len(res.handles) - checked} requests differ from the direct engine")
    if restored["state"] != "alive" or restored["flushes"] == 0:
        failures.append(f"the restored replica is {restored['state']} with "
                        f"{restored['flushes']} flushes")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
