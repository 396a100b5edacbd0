"""Plain-text report over a persisted telemetry trace.

  PYTHONPATH=src python -m repro_torch.telemetry.report trace.jsonl
  PYTHONPATH=src python -m repro_torch.telemetry.report trace.json --top 10

Accepts either sink format (JSONL event log or Chrome trace JSON) and
prints the per-span-name aggregate table plus counters and gauges --
the quick look before opening the trace in ``chrome://tracing`` /
Perfetto.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.telemetry.sinks import load_trace, summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Summarize a telemetry trace (JSONL or Chrome JSON).")
    ap.add_argument("trace", help="path written by --trace / write_jsonl / "
                                  "write_chrome_trace")
    ap.add_argument("--top", type=int, default=30,
                    help="span names shown, by total time (default 30)")
    args = ap.parse_args(argv)
    trace = load_trace(args.trace)
    print(f"{args.trace}: {len(trace['spans'])} span(s), "
          f"{len(trace['counters'])} counter(s), "
          f"{len(trace['gauges'])} gauge(s)")
    print(summarize(trace, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
