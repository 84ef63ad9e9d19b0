#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 5]

For each seed, in one process: the cell's inputs from the seed, a warm
call, a short window of calls at the cell's own load, and the check of its
answers as a run makes it (the program's reading, the lower one); then the
control: the plain reference in bfloat16, the precision below the
configuration's float32, put in the program's place on the same sampled
fields under the same stopping rule and judged the same way (the upper
reading).  One JSON line a seed.  The benchmark's runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_answers(cell, answers, pool, device, dtype):
    """The reference in ``dtype`` in the program's place: for each sampled
    field, its own solve under the stopping rule, NaN where the forcing is
    undefined."""
    import numpy as np

    from benchmark.harness import judge
    from benchmark.reference import redblack
    cfg, k = cell.config, cell.mix["fields_per_call"]
    keys = sorted({(a.pool, a.index) for a in answers})
    values = np.stack([judge.field_values(pool, k, *key) for key in keys])
    prob = cell.reference.build(cfg, values, dtype, device)
    ip = cfg["iParams"]
    S, n = redblack.solve(prob, redblack.relaxation(cell.reference,
                                                    values.shape[1:]),
                          float(ip["tolerance"]), int(cfg["check_window"]),
                          int(ip["mxLoop"]))
    S = S.double().cpu().numpy()
    n = n.cpu().numpy()
    return [judge.Answer(p, j, np.where(np.isnan(values[i]), np.nan, S[i]),
                         int(n[i])) for i, (p, j) in enumerate(keys)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import xinvert_tpu_torch  # noqa: F401  (the program under test)
    from benchmark.harness import cell as cells, judge, window
    from xinvert_tpu_torch.models import api
    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg, mix = cell.config, cell.mix
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        rng_in, rng_sample = window.streams(seed)
        pool, fields, entry, kw = window.prepare(cell, rng_in)
        entry(fields[0], **kw)
        calls, t0, t1 = window._loop(entry, fields, kw, args.seconds,
                                     float("inf"), api, torch.cuda.synchronize)
        failed, mismatch = judge.scan_calls(calls, pool)
        answers = judge.sample(calls, mix["fields_per_call"],
                               mix["check_fields"], rng_sample)
        prog = judge.judge(cfg, cell.reference, answers, pool,
                           mix["fields_per_call"], "cuda")
        prog["mask_mismatch"] = mismatch
        ctrl_ans = control_answers(cell, answers, pool, "cuda",
                                   torch.bfloat16)
        ctrl = judge.judge(cfg, cell.reference, ctrl_ans, pool,
                           mix["fields_per_call"], "cuda")
        sweeps = np.concatenate([c.sweeps for c in calls])
        print(json.dumps({
            "seed": seed, "calls": len(calls), "failed": failed,
            "answers": len(answers), "program": prog, "control": ctrl,
            "control_sweeps": sorted({a.sweeps for a in ctrl_ans}),
            "program_sweeps": [int(sweeps.min()), float(np.median(sweeps)),
                               int(sweeps.max())],
            "fields_per_s": mix["fields_per_call"] * len(calls) / (t1 - t0),
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
