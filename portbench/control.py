#!/usr/bin/env python3
"""The readings a cell's limit is set from: the program's gap and the
control's, seed by seed, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \

For each seed: a full set-up, then one pass of the cell's traffic (one
call of an ``all`` mix; every clip once of a ``one`` mix), then the
check's sample read by the reference and by the control, the reference
put in the program's place at the next precision below the one the cell
states (``fp8`` for the bf16 default path, ``serving-int4`` for the int8
serving path) and judged there: ``control_correct`` is the run's
``correct`` with the control's numbers compared. One JSON line per seed
(the program's readings, the control's, the planted faults of the token
times), then the lower readings (the program's largest) and the upper
ones (the control's and each fault's smallest). A mix without word
times has no token times, no ``ts`` and no planted faults. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_mode(mix: dict) -> str:
    return ("serving-int4" if mix["pipeline"]["quantize"] == "serving"
            else "fp8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import generator, harness

    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    workload = {w["name"]: w for w in bench["workloads"]}[args.workload]
    mix = harness.load(harness.HERE, "traffic", workload["traffic"])
    mode = control_mode(mix)
    n_calls = (1 if mix["per_call"] == "all"
               else len(generator.lengths(mix["lengths"])))
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res, _, r = harness.run_cell(bench, workload, seed, 0.0, False, t0,
                                     n_calls=n_calls, control=mode)
        rows.append(r)
        c = r["control"]
        line = {
            "seed": seed, "control_correct": res["correct"],
            "logit_gap": r["logit_gap"], "ts": r.get("ts"),
            "stitch_mismatch": r["stitch_mismatch"],
            "control_logit_gap": c["logit_gap"], "control_ts": c.get("ts"),
            "faults": r.get("faults"), "tokens": r["tokens"],
            "distinct_tokens": r["distinct_tokens"],
            "median_margin": r["median_margin"],
            "seconds": time.perf_counter() - t0}
        print(json.dumps({k: v for k, v in line.items() if v is not None}),
              flush=True)
    summary = {
        "workload": args.workload, "control": mode, "seeds": len(rows),
        "lower_logit_gap": max(r["logit_gap"] for r in rows),
        "upper_control_gap": min(r["control"]["logit_gap"] for r in rows)}
    if "ts" in rows[0]:
        stats = rows[0]["ts"].keys()
        summary.update(
            lower_ts={k: max(r["ts"][k] for r in rows) for k in stats},
            upper_ts={f: {k: min(r["faults"][f][k] for r in rows)
                          for k in stats} for f in rows[0]["faults"]},
            control_ts_min={k: min(r["control"]["ts"][k] for r in rows)
                            for k in stats})
    summary["seconds"] = time.perf_counter() - T0
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
