"""``chip_smoke.py`` phase 20 (row sharding) on any placement of the shards.

    python3 tools/shard_check.py [--devices cuda:0,cuda:1 ...]
                                 [--small-devices cuda:0,cuda:1,cuda:2]

Sets up the bench point on ``cuda:0`` and runs phase 5's 20 projection
steps, then phase 20 (``chip_smoke.phase_sharded``) once per
``--devices`` list: the bench point on those row shards, 3 steps and the
F, mass, G, B, convection and block-Jacobi results bit for bit against
the one-device model, bytes per shard and per card, ms per step beside
the one-device steps; then the small fixture in monolithic ``cc`` on
``--small-devices`` against one device.  Default: two shards on each of
the first two cards.  Exits with another code than 0 if a check fails.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", default=["cuda:0,cuda:1"],
                    help="comma-separated shard devices, one list per run")
    ap.add_argument("--small-devices", default="cuda:0,cuda:1,cuda:2")
    args = ap.parse_args()
    os.makedirs(cs.WORK, exist_ok=True)
    card = cs.phase_device()
    cs.phase_build()
    ns = cs.bench_model("cuda").setup()
    bench = cs.phase_bench(ns, card)
    for devs in args.devices:
        cs.phase_sharded(ns, bench, card, devices=devs.split(","),
                         small_devices=args.small_devices.split(","))
    cs.log(f"shard_check: every run passed on {torch.cuda.device_count()} "
           f"cards: {card}")


if __name__ == "__main__":
    main()
