"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the precision below the configuration's
(float32 -> bfloat16), judged by the same comparison as a run. It has to
come out not correct; ``PERF.md`` keeps its readings beside the program's.

    python3 streambench/control.py --workload <name> --seeds 1 2 3 \
        [--frames 4] [--precision bfloat16]

Per seed it makes ``--frames`` consecutive frames of each display's source
at the cell's geometry, has the control encode each (every changed stripe
at the profile's quality), and judges them against the float32 reference.
Prints one JSON line: frames compared and mismatched per seed. With
``--precision float32`` the reference judges its own bytes (0 mismatched).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(res: dict, seed: int, frames: int, precision: str, device,
             geometry=None, displays=None) -> dict:
    from streambench.harness import reference_module
    from streambench.reference import Encoded, Session
    from streambench.source import Pattern

    config, traffic = res["config"], res["traffic"]
    w, h = geometry or (int(config["width"]), int(config["height"]))
    cfg = {**config, "width": w, "height": h}
    mod = reference_module(config["reference"])
    control = mod.make(cfg, device=device, precision=precision)
    judge = mod.make(cfg, device=device, precision="float32")
    compared = mismatched = 0
    why = []
    for d in range(int(displays or traffic["displays"])):
        pat = Pattern(w, h, seed + d, traffic["content"],
                      int(traffic.get("scroll_rows", 4)))
        session = Session(f"d{d}", pat.frame,
                          [Encoded(k, k + 1, "acked") for k in range(frames)])
        for e, msgs in zip(session.encoded, control.encode_session(session)):
            e.messages = msgs
        for v in judge.judge_session(session, range(frames)):
            compared += 1
            if not v["ok"]:
                mismatched += 1
                why.append(v["why"])
    return {"seed": seed, "precision": precision, "compared": compared,
            "mismatched": mismatched, "why": why[:3]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a comparison")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--precision", default="bfloat16")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from streambench.harness import resolve

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 3
    res = resolve(args.workload)
    t0 = time.monotonic()
    out = [readings(res, s, args.frames, args.precision, "cuda")
           for s in args.seeds]
    print(json.dumps({"workload": args.workload, "readings": out,
                      "seconds": time.monotonic() - t0,
                      "kind": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
