"""Device memory alive when ``chip_smoke.py``'s phase 22 starts, by pool
and by tensor, on one GPU.

    python3 tools/phase22_memory.py [--tree DIR]

Runs the ``chip_smoke.py`` of ``--tree`` (default: this checkout) with its
own package, from its start through phase 22 (the captured and eager
monolithic runs at the bench point, whose peak ``chip_smoke.py`` prints),
and stops there.  So two versions of the port can be compared in one run
on the same card.  At phase 22's start it prints:

* the bytes allocated on the card, and by memory pool
  (``torch_step_profile.pool_bytes``): the monolithic model's graph pool,
  its conditional nodes' pool, and the rest;
* the CUDA tensors that Python still reaches (``gc``), one per storage,
  summed by shape and dtype, the largest first: what the earlier phases
  left alive beside the monolithic model.

Then phase 22's own lines, and last one JSON object with these numbers
and phase 22's peak.
"""

import argparse
import collections
import gc
import importlib.util
import json
import os
import sys

import torch

from torch_step_profile import pool_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    pass


def live_tensors(top):
    """CUDA tensors reachable from Python, one per storage: (bytes in
    all, [[shape, dtype, count, bytes], ...] largest first)."""
    seen, groups = set(), collections.defaultdict(lambda: [0, 0])
    for obj in gc.get_objects():
        try:
            if not (torch.is_tensor(obj) and obj.is_cuda):
                continue
            st = obj.untyped_storage()
        except Exception:
            continue
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        key = (tuple(obj.shape), str(obj.dtype).replace("torch.", ""))
        groups[key][0] += 1
        groups[key][1] += st.nbytes()
    rows = sorted(([list(k[0]), k[1], c, b] for k, (c, b) in groups.items()),
                  key=lambda r: -r[3])
    return sum(r[3] for r in rows), rows[:top]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose chip_smoke.py and package run")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase22_memory: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    tag = f"[{os.path.basename(tree)}]"
    phase22 = smoke.phase_monolithic_graphs
    out = {"tree": os.path.basename(tree)}

    def measured(mono, card):
        gc.collect()
        torch.cuda.synchronize()
        pools = pool_bytes(mono["ns"])
        reached, rows = live_tensors(args.top)
        out.update(card=card, allocated=torch.cuda.memory_allocated(),
                   reserved=torch.cuda.memory_reserved(), pools=pools,
                   python_reached=reached, tensors=rows)
        print(f"{tag} phase 22 starts: {out['allocated']} bytes allocated, "
              f"{out['reserved']} reserved; by pool [allocated, reserved] "
              f"{pools}; CUDA tensors reached from Python {reached} bytes, "
              f"on {card}", flush=True)
        for shape, dtype, n, b in rows:
            print(f"{tag}   {b:12d} bytes {n:4d} x {shape} {dtype}",
                  flush=True)
        res = phase22(mono, card)
        out["peak_22"] = res["peak_bytes"]
        print(f"{tag} phase 22 peak {res['peak_bytes']} bytes", flush=True)
        raise _Stop

    smoke.phase_monolithic_graphs = measured
    try:
        smoke.main()
    except _Stop:
        pass
    print(json.dumps(out), flush=True)
    return 0 if "peak_22" in out else 1


if __name__ == "__main__":
    sys.exit(main())
