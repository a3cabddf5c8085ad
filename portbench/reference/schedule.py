"""A plain check of the schedule an engine reported.

Each record is one request as plain numbers: its class (``hp``), home
slice, arrival, deadline, final state, completion time, tokens served and
asked for, and where its final run was placed (slice, units, start, end).
The claimed slot lengths come from the task types the benchmark built.

Faults counted:
  * a request done after its deadline, started before it arrived, or whose
    completion is not its slot's end;
  * a slot shorter than the claimed execution time plus padding at its
    units, or an HP request off its home slice or on more than one unit;
  * a done request without exactly the tokens it asked for, or a token
    outside the vocabulary;
  * more units in use on a slice at some instant than the slice has (the
    done runs were never preempted, so their whole slots were held).
"""
from __future__ import annotations

EPS = 1e-9


def check(records: list, slots: dict, n_slices: int, capacity: int,
          vocab: int) -> list:
    """-> a list of fault messages (empty: the schedule holds)."""
    faults = []
    runs = {s: [] for s in range(n_slices)}
    for r in records:
        if r["state"] != "done":
            continue
        rid = r["rid"]
        if r["completed_at"] > r["deadline"] + EPS:
            faults.append(f"{rid}: done at {r['completed_at']} after its "
                          f"deadline {r['deadline']}")
        if r["t_start"] < r["arrival"] - EPS:
            faults.append(f"{rid}: started at {r['t_start']} before its "
                          f"arrival {r['arrival']}")
        if abs(r["t_end"] - r["completed_at"]) > EPS:
            faults.append(f"{rid}: completed at {r['completed_at']}, its "
                          f"slot ends at {r['t_end']}")
        claim = slots[r["task_type"]][r["units"]]
        if r["t_end"] - r["t_start"] < claim - EPS:
            faults.append(f"{rid}: slot {r['t_end'] - r['t_start']} under "
                          f"its claim {claim}")
        if r["hp"] and (r["units"] != 1 or r["slice"] != r["home"]):
            faults.append(f"{rid}: HP on slice {r['slice']} with "
                          f"{r['units']} units (home {r['home']})")
        if len(r["tokens"]) != r["max_new_tokens"]:
            faults.append(f"{rid}: {len(r['tokens'])} tokens of "
                          f"{r['max_new_tokens']}")
        if any(not 0 <= t < vocab for t in r["tokens"]):
            faults.append(f"{rid}: a token outside the vocabulary")
        if not 0 <= r["slice"] < n_slices:
            faults.append(f"{rid}: on slice {r['slice']}")
            continue
        runs[r["slice"]].append((r["t_start"], r["t_end"], r["units"]))
    for s, rs in runs.items():
        # a run ending at an instant (to rounding) frees its units before
        # one starting there takes them
        events = sorted([(t0, 1, u) for t0, _, u in rs]
                        + [(t1 - EPS, 0, -u) for _, t1, u in rs])
        used = 0
        for t, _, du in events:
            used += du
            if used > capacity:
                faults.append(f"slice {s}: {used} units in use at {t}")
                break
    return faults
