"""Compare the non-timing numbers of two ``chip_smoke.py`` logs.

Usage: python3 tools/smoke_gaps.py PARENT.log CHANGE.log

Each JSON line of a log is keyed by its phase and its other top-level
string fields (config, kernel, shape, precision, ...) and its order among
lines with the same key.  For each line the two logs share, every numeric
leaf is compared unless a component of its path names a time, a rate, a
share of time, a memory or byte size, a sample count, the kernel events of
a profiler trace or a PyTorch library call's own error (``SKIP``: none of
them a result of the port's arithmetic that repeats run to run): what
remains are the gaps, errors, likelihoods, predictions, iteration and
launch counts.  Prints one JSON line: how many values were compared, how
many differ (with the first 50), and the lines found in one log only.
Exit code 0 when no compared value differs.
"""

from __future__ import annotations

import json
import re
import sys

SKIP = re.compile(
    r"(^|_)(ms|s|seconds|wall|device|idle|busy|peak|gb|bytes|members|nvml|spawn|time|steps|samples)(_|$)"
    r"|gb_per_s|GBs|assembly|predict_\d|refresh_basis|^stats$|train_(un)?profiled|^card$"
    r"|^kernel_events$|^library_rel_err",
    re.IGNORECASE,
)
IGNORED_STRINGS = {"card", "nvidia_smi", "torch", "cuda", "name"}


def _leaves(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (str(i),))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def _lines(path: str) -> dict:
    out, seen = {}, {}
    with open(path) as f:
        for text in f:
            try:
                rec = json.loads(text)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            ident = tuple(sorted((k, v) for k, v in rec.items() if isinstance(v, str) and k not in IGNORED_STRINGS))
            ident = ident or (("keys", ",".join(rec)),)
            n = seen.get(ident, 0)
            seen[ident] = n + 1
            out[(ident, n)] = rec
    return out


def compare(parent: str, change: str) -> dict:
    a, b = _lines(parent), _lines(change)
    compared, differ = 0, []
    for key in a.keys() & b.keys():
        va = dict(_leaves(a[key]))
        for path, x in _leaves(b[key]):
            if path not in va or any(SKIP.search(p) for p in path if not p.isdigit()):
                continue
            compared += 1
            if va[path] != x:
                differ.append({"line": dict(key[0]), "path": "/".join(path), "parent": va[path], "change": x})
    return {"compared": compared, "differ": len(differ), "first_differences": differ[:50],
            "only_parent": [dict(k[0]) for k in a.keys() - b.keys()],
            "only_change": [dict(k[0]) for k in b.keys() - a.keys()]}


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(2)
    result = compare(sys.argv[1], sys.argv[2])
    print(json.dumps(result))
    sys.exit(0 if result["differ"] == 0 else 1)
