#!/usr/bin/env python3
"""Time the port's K2 ``sweep_scan`` and K8 ``decode_enc`` kernels at the
chr path's shapes, on one NVIDIA GPU, for the ``pandepth_tpu_torch`` of a
given checkout:

    python3 tools/kernel_ab.py [--root DIR] [--iters N] [--out FILE]

``--root`` is the directory that holds the package (default: this
repository), so two commits compare in one process each, on one card:
unpack the other commit into a directory that ``.gitignore`` lists and
run both in turns (A, B, B, A). The timing is ``chip_smoke.py``'s own
(``cuda_ms``: CUDA events around ``--iters`` calls after a warm-up;
``device_ms``: the same calls' device time under torch.profiler, which
leaves out the host's gaps between launches, with the kernels and
memsets a call puts on the card), taken from this repository's
``chip_smoke.py`` whatever the root. The inputs are made on the card from
fixed seeds, the same for every root:

- sweep_scan: 15,199,506 sorted uint32-tier events (the chr fixture's
  count; int64 words, positions below 3e9, deltas of +-1), min_dep 1, no
  wrap18;
- decode_enc: the encoded chr path's const u16 group, blocks of 8 and 6
  windows of 2^19 slots with 8,192 escape entries each (three used),
  through ``sweep.decode_const_group`` as ``chip_smoke.py`` times it.

Each kernel is first held array-equal to its plain twin. Prints one JSON
line, and appends it to the file ``--out`` names, if given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import cuda_ms, device_ms  # noqa: E402

sys.path.remove(HERE)

N_EVENTS = 15_199_506
CAP, CE, ROWS = 1 << 19, 8192, (8, 6)
U32_MAX = 0xFFFFFFFF


def sweep_inputs(dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    pos = torch.randint(0, 3_000_000_000, (N_EVENTS,), generator=g,
                        device=dev, dtype=torch.int64)
    pos_s = torch.sort(pos)[0]
    delta = (torch.randint(0, 2, (N_EVENTS,), generator=g, device=dev,
                           dtype=torch.int32) * 2 - 1)
    return pos_s, delta


def decode_group(dev):
    """(codes, excs, slots, bases, lens, ns) of the const u16 group, on
    the card: random codes below the escape, three escapes a row."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    codes, excs, slots = [], [], []
    for rows in ROWS:
        c = torch.randint(0, 300, (rows, CAP), generator=g, device=dev,
                          dtype=torch.int32)
        s = torch.full((rows, CE), CAP, dtype=torch.int32, device=dev)
        s[:, :3] = torch.tensor([5, CAP // 2, CAP - 1], dtype=torch.int32)
        c.scatter_(1, s[:, :3].long(), 0xFFFF)
        e = torch.zeros((rows, CE), dtype=torch.int64, device=dev)
        e[:, :3] = torch.tensor([40_000_000, -3_000, 90_000])
        codes.append(c.to(torch.int16))   # uint16 bits
        excs.append(e)
        slots.append(s)
    n = sum(ROWS)
    bases = torch.randint(0, 2_900_000_000, (n,), generator=g, device=dev,
                          dtype=torch.int64)
    lens = torch.full((n,), 150, dtype=torch.int32, device=dev)
    ns = torch.full((n,), CAP, dtype=torch.int32, device=dev)
    ns[-1] = CAP // 3
    return tuple(codes), tuple(excs), tuple(slots), bases, lens, ns


def timed(fn, want, iters: int) -> dict:
    same = all(a.equal(b) for a, b in zip(fn(), want))
    ms = cuda_ms(fn, iters)
    dms, nk, nm = device_ms(fn, iters)
    return {"equal_to_twin": same, "ms": ms, "device_ms": dms,
            "kernels_per_call": nk, "memsets_per_call": nm}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="a JSON-lines file to append the result to")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from pandepth_tpu_torch.device import kernels, sweep

    if not kernels.SOURCE.is_relative_to(root):
        print(f"kernel_ab: imported {kernels.SOURCE}, not from {root}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    kernels.library()
    out = {"root": root, "card": card, "iters": args.iters}

    pos_s, delta = sweep_inputs(dev)
    want = sweep.sweep_scan_reference(pos_s, delta, 1, False, U32_MAX)
    out["sweep_scan"] = {"events": N_EVENTS, **timed(
        lambda: kernels.sweep_scan(pos_s, delta, 1, False, U32_MAX), want,
        args.iters)}
    del pos_s, delta, want

    grp = decode_group(dev)
    want = sweep.decode_const_group_reference(*grp, pos_max=U32_MAX)
    out["decode_enc"] = {"windows": sum(ROWS), "blocks": len(ROWS), **timed(
        lambda: sweep.decode_const_group(*grp, pos_max=U32_MAX), want,
        args.iters)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0 if out["sweep_scan"]["equal_to_twin"] \
        and out["decode_enc"]["equal_to_twin"] else 1


if __name__ == "__main__":
    sys.exit(main())
