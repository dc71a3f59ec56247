"""Time phase 14 (b)'s world decode of two checkouts in turns on one card.

    python scripts/lm_world_decode_turns.py PARENT_DIR CHANGE_DIR \
        [--order pccp] [--out build/lm_world_turns.json]
        [--device cuda] [--config get_config] [--part 0] [--dtype float32]

Each turn runs, in a process of its own rooted at one checkout (``p``: the
first directory, ``c``: the second), that checkout's
``chip_smoke.lm_world_full`` for one full-width part (``--part``, by
default the first: minitron_4b in float32; ``--dtype`` another dtype):
one rank, then a world of (1, 1, 2) sharing the card; and prints
one JSON line: s a decode step of the world and of the single rank, the
collectives of a world decode step by kind and their bytes (rank 0), each
rank's step peak, and the forward / decode errors against the single rank.
The card's name and power limit come first.  Run the turns in one call to
compare two versions on one host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = """
import json, sys, chip_smoke
part = chip_smoke.LM_WORLD_FULL[int(sys.argv[3])]
if sys.argv[4]:
    part = part[:3] + (sys.argv[4],) + part[4:]
rec, _ = chip_smoke.lm_world_full(sys.argv[1], (part,), sys.argv[2])
name = part[0]
part = rec[name]
gen = [r["generate"] for r in part["ranks"]]
print("TURN " + json.dumps({
    "part": name, "dtype": sys.argv[4] or None, "world_s": rec["world_s"],
    "s_per_step": [g["s_per_step"] for g in gen],
    "single_s_per_step": part["single"]["s_per_step"],
    "collectives_per_step": gen[0]["collectives_per_step"],
    "collective_bytes_per_step": gen[0]["collective_bytes_per_step"],
    "step_peak_gib": [r["step_peak_gib"] for r in part["ranks"]],
    "forward_max_err": part["forward_max_err"],
    "decode_max_err": part.get("decode_max_err"),
    "generate_rows_differ": part["generate_rows_differ"]}))
"""


def turn(root: str, device: str, config: str, part: int, dtype: str
         ) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.join(root, "src")]))
    proc = subprocess.run([sys.executable, "-c", TURN, device, config,
                           str(part), dtype],
                          cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"turn in {root} failed (rc {proc.returncode}):"
                           f"\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][5:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--out", default="build/lm_world_turns.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--part", type=int, default=0,
                    help="the index of the part in LM_WORLD_FULL")
    ap.add_argument("--dtype", default="",
                    help="run the part in this dtype (default its own)")
    ap.add_argument("--config", default="get_config",
                    help="configs.base's function (get_reduced_config "
                         "rehearses the turns on the CPU)")
    args = ap.parse_args(argv)
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(card.strip(), flush=True)
    roots = {"p": os.path.abspath(args.parent),
             "c": os.path.abspath(args.change)}
    out = {"card": card.strip(), "turns": []}
    for which in args.order:
        rec = dict(turn(roots[which], args.device, args.config, args.part,
                        args.dtype), which=which)
        out["turns"].append(rec)
        print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
