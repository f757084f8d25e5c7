"""Compare two run cards or digest trails (torch port of
``tools/audit_diff.py``).

Usage::

    python -m cimba_tpu_torch.tools.audit_diff A.json B.json [--json]

``A`` and ``B`` are run cards (written by
``run_experiment_stream(audit=DIR)``) or bare digest-trail JSON lists.
The report names the first divergent (wave, chunk, class), environment
drift, and whether the result digests are equal.

Exit codes::

    0  identical (comparable, no trail divergence, results not unequal)
    1  divergence (trail or result digest differs)
    2  incomparable (different spec, geometry or kind) or a usage error
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from cimba_tpu_torch.obs import audit

    ap = argparse.ArgumentParser(
        description="compare two run cards / digest trails")
    ap.add_argument("a", nargs="?", help="run card (or trail list) JSON")
    ap.add_argument("b", nargs="?", help="run card (or trail list) JSON")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON instead of text")
    ap.add_argument("--force", action="store_true",
                    help="compare trails even when the cards look "
                    "incomparable (different spec fingerprint / geometry)")
    ap.add_argument("--version", action="store_true",
                    help="print the cimba_tpu_torch version and exit")
    args = ap.parse_args(argv)
    if args.version:
        import cimba_tpu_torch

        print(cimba_tpu_torch.__version__)
        return 0
    if args.a is None or args.b is None:
        ap.error("two run cards (or trail lists) are required")
    try:
        a = audit.load_run_card(args.a)
        b = audit.load_run_card(args.b)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"audit_diff: {e}", file=sys.stderr)
        return 2

    rep = audit.diff_cards(a, b)
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
    else:
        for r in rep["reasons"]:
            print(f"incomparable: {r}")
        ea, eb = a.get("env") or {}, b.get("env") or {}
        for k in rep["env_drift"]:
            print(f"env drift: {k}: {ea.get(k)!r} vs {eb.get(k)!r}")
        if rep["seeds_differ"]:
            print(f"seed schedule differs: {a.get('seed_schedule')} vs "
                  f"{b.get('seed_schedule')}")
        d = rep["first_divergence"]
        if d is not None:
            print(f"FIRST DIVERGENCE at wave {d.get('wave')} chunk "
                  f"{d.get('chunk')} class(es) {','.join(d['classes'])} "
                  f"(trail row {d['index']}; lengths {rep['trail_len']})")
            if "a" in d:
                print(f"  a: {d['a']}")
                print(f"  b: {d['b']}")
        if rep["result_equal"] is False:
            print(f"result digest differs: {a.get('result_digest')} vs "
                  f"{b.get('result_digest')}")
        if rep["identical"]:
            print(f"identical: {rep['trail_len'][0]} trail rows match"
                  + (", result digests equal" if rep["result_equal"]
                     else ""))
    if not rep["comparable"] and not args.force:
        return 2
    if rep["first_divergence"] is not None or rep["result_equal"] is False:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
