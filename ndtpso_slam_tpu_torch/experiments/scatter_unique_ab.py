"""The flat-fleet row scatter on the card, beside the library calls that do
the same job.

Port of ``experiments/scatter_unique_ab.py``: the fleet's shapes (B=8
robots, C=360,000 cells each, M=12,288 update rows per step, R = B·C flat
rows plus a junk row for dropped ids) and its id stream (per robot ~220
distinct cells around a pose, each hit by several beams).  It times, per
call (CUDA events over REPS calls after a warm one):

* ``row_scatter``: the port's kernel (``ops/row_scatter.py``), one field,
  and ``row_scatter_3``: three fields on one id stream;
* ``index_copy`` (``op.index_copy_(0, ids, vals)``) and ``index_put``
  (``op[ids] = vals``);
* ``index_copy_sorted`` and ``index_copy_unique``: the same on sorted ids,
  and on the deduplicated ids with the rows that win them, beside their
  preparation (``prep_sorted``: ``torch.sort``; ``prep_unique``:
  ``torch.unique`` and the winning rows);
* ``gather``: the matching read ``op[ids]``;
* ``scan_*``: 50 scatters back to back on one tensor, per step (the TPU
  study's scan-carry context);

at the real field width W=2 over the 2.88 M flat rows (a shape the TPU
kernel could not run: Mosaic rejects row slices narrower than 128 floats),
and at the TPU's W=128 over 360,001 rows.  It checks the kernel bit-equal
to ``index_copy_`` on unique ids, and on the study's duplicate-laden ids
that every written row is one of the rows aimed at it and every other row
is untouched.  Prints one JSON object to standard output.

    python -m ndtpso_slam_tpu_torch.experiments.scatter_unique_ab [--device cpu]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ndtpso_slam_tpu_torch.experiments import describe, log, parse_device, time_ms
from ndtpso_slam_tpu_torch.ops import row_scatter as rsc

B, C, M = 8, 360_000, 12_288  # robots, cells, update rows per step
R = B * C
W = 2  # field row width (cur_sum-like)
W_TPU = 128  # the only row width the TPU kernel could move
REPS = 30
SCAN_T = 50


def fleet_ids(b=B, c=C, m=M, seed=0):
    """The study's id stream [M] (int64): per robot, ~220 distinct cells
    around a pose, each hit by several beams."""
    rs = np.random.RandomState(seed)
    per = m // b
    ids = np.empty((b, per), np.int64)
    for r in range(b):
        centers = rs.randint(0, c, 220)
        ids[r] = r * c + centers[rs.randint(0, 220, per)]
    return ids.reshape(-1), rs


def duplicate_rule(before, after, idx, vals):
    """True when every row aimed at holds one of the rows aimed at it, and
    every other row of ``after`` equals ``before``."""
    rows = after.shape[0]
    keep = (idx >= 0) & (idx < rows)
    ids, v = idx[keep], vals[keep]
    uniq, inv = torch.unique(ids, return_inverse=True)
    match = (after[ids] == v).all(dim=1).to(torch.int64)
    hit = torch.zeros(uniq.shape, dtype=torch.int64, device=idx.device)
    hit.scatter_reduce_(0, inv, match, "amax")
    untouched = torch.ones(rows, dtype=torch.bool, device=idx.device)
    untouched[uniq] = False
    return bool(hit.all()) and bool(torch.equal(after[untouched], before[untouched]))


def unique_prep(fid, vals, rows):
    """The deduplicated id stream and the rows that win it."""
    targets, winners = rsc.winners(fid, rows)
    return targets, vals[winners]


def study(device, width, n_rows, fid, vals, fused=True, reps=REPS):
    """Timings (ms per call) and checks at one row width over ``n_rows``
    real rows (operands [n_rows + 1, width])."""
    op = torch.zeros((n_rows + 1, width), dtype=torch.float32, device=device)
    tag = "" if width == W else f"_w{width}"
    res = {}

    def timed(label, fn, n=reps):
        res[label + tag] = time_ms(fn, n, device)
        log(f"{label + tag:22s}: {res[label + tag]:8.4f} ms ({res[label + tag] / len(fid) * 1e6:7.1f} ns/row)")

    fid_sorted = torch.sort(fid).values
    fid_u, vals_u = unique_prep(fid, vals, n_rows + 1)
    timed("row_scatter", lambda: rsc.row_scatter([op], fid, [vals]))
    if fused:
        ops3 = [op, op.clone(), op.clone()]
        vals3 = [vals, vals + 1.0, vals + 2.0]
        timed("row_scatter_3", lambda: rsc.row_scatter(ops3, fid, vals3))
    timed("index_copy", lambda: op.index_copy_(0, fid, vals))
    timed("index_put", lambda: op.__setitem__(fid, vals))
    timed("index_copy_sorted", lambda: op.index_copy_(0, fid_sorted, vals))
    timed("index_copy_unique", lambda: op.index_copy_(0, fid_u, vals_u))
    timed("prep_sorted", lambda: torch.sort(fid))
    timed("prep_unique", lambda: unique_prep(fid, vals, n_rows + 1))
    timed("gather", lambda: op[fid])

    def scan(step):
        def run():
            for _ in range(SCAN_T):
                step()
        return run

    for label, step in (("scan_row_scatter", lambda: rsc.row_scatter([op], fid, [vals])),
                        ("scan_index_copy", lambda: op.index_copy_(0, fid, vals))):
        res[label + tag] = time_ms(scan(step), 1, device) / SCAN_T
        log(f"{label + tag:22s}: {res[label + tag]:8.4f} ms/step in a {SCAN_T}-step chain")

    # Checks: unique ids bit-equal to index_copy_; duplicates by the rule.
    base = torch.randn((n_rows + 1, width), generator=torch.Generator().manual_seed(1)).to(device)
    got = base.clone()
    rsc.row_scatter([got], fid_u, [vals_u])
    want = base.clone().index_copy_(0, fid_u, vals_u)
    res["correct" + tag] = bool(torch.equal(got, want))
    got = base.clone()
    rsc.row_scatter([got], fid, [vals])
    res["duplicate_rule" + tag] = duplicate_rule(base, got, fid, vals)
    log(f"row_scatter{tag} vs index_copy_ on unique ids: {res['correct' + tag]}; "
        f"duplicate rule: {res['duplicate_rule' + tag]}")
    return res


def run(device, b=B, c=C, m=M, reps=REPS):
    """The study at W=2 over b*c rows and at W=128 over c rows.  Returns the
    results dict the JSON line prints."""
    ids, rs = fleet_ids(b, c, m)
    fid = torch.from_numpy(ids).to(device)
    vals = torch.from_numpy(rs.randn(m, W).astype(np.float32)).to(device)
    n_real = len(np.unique(ids))
    log(f"M={m} rows, {n_real} unique real rows after dedup")
    results = {"unique_rows": n_real}
    results.update(study(device, W, b * c, fid, vals, reps=reps))
    vals128 = torch.from_numpy(rs.randn(m, W_TPU).astype(np.float32)).to(device)
    results.update(study(device, W_TPU, c, fid % c, vals128, fused=False, reps=reps))
    return results


def main(argv=None):
    device = parse_device(__doc__.splitlines()[0], argv)
    log("device:", describe(device))
    results = run(device)
    print(json.dumps({"done": True, "device": describe(device),
                      "ms": {k: round(v, 4) if isinstance(v, float) else v
                             for k, v in results.items()}}))


if __name__ == "__main__":
    main()
