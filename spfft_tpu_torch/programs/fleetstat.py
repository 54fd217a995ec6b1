"""fleetstat: scrape, merge, validate and export fleet metrics.

The port of ``programs/fleetstat.py``, the operator CLI of the fleet
observability layer (:mod:`spfft_tpu_torch.obs.fleet`): scrapes each named host's ``obs.snapshot()``
over the ``metrics`` RPC op (one bounded ``SPFFT_TPU_FLEET_SCRAPE_S``
deadline per host — a dead host is stamped ``unreachable``, never a hung
scrape) and merges them into one host-labeled ``spfft_tpu.obs.fleet/1``
document, validated before it is written. ``--check`` re-validates an
existing document instead of scraping (the CI hook proving a doctored
document trips the schema pin), ``--prom`` renders the Prometheus
exposition text. It moves no tensor: it runs the same on the card's machine
and on the CPU.

Exit status: 0 clean, 1 usage/scrape error (no host answered), 3 validation
findings (distinct, so CI can tell "schema tripped" from "tool broken" —
the ``perf_gate.py`` discipline).

Usage:
    python -m spfft_tpu_torch.programs.fleetstat --host host0=127.0.0.1:4242 \
        --host host1=127.0.0.1:4243 -o fleet.json
    python -m spfft_tpu_torch.programs.fleetstat --host host0=127.0.0.1:4242 --prom
    python -m spfft_tpu_torch.programs.fleetstat --check fleet.json
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--host", action="append", default=[], metavar="NAME=ADDR:PORT",
        help="one worker host to scrape (repeatable)",
    )
    p.add_argument(
        "--check", default=None, metavar="FLEET_JSON",
        help="validate an existing fleet document instead of scraping",
    )
    p.add_argument(
        "--timeout-s", type=float, default=None,
        help="per-host scrape deadline (default SPFFT_TPU_FLEET_SCRAPE_S)",
    )
    p.add_argument(
        "--prom", action="store_true",
        help="print the Prometheus exposition text instead of JSON",
    )
    p.add_argument("-o", "--output", default=None, help="write JSON here")
    return p


def _parse_hosts(specs: list) -> list:
    """[(name, address)] from NAME=ADDR:PORT specs (typed on malformed)."""
    out = []
    for spec in specs:
        name, eq, address = spec.partition("=")
        if not eq or not name or not address:
            raise SystemExit(
                f"malformed --host {spec!r}: expected NAME=ADDR:PORT"
            )
        out.append((name, address))
    return out


def _report(doc: dict, findings: list) -> None:
    states = {
        h: entry.get("state") for h, entry in doc.get("hosts", {}).items()
    }
    print(
        f"fleet: {len(states)} hosts "
        f"({sum(1 for s in states.values() if s == 'live')} live), "
        f"{len(doc.get('counters', {}))} counters, "
        f"{len(doc.get('gauges', {}))} gauges, "
        f"{len(doc.get('histograms', {}))} histograms",
        file=sys.stderr,
    )
    for host, state in sorted(states.items()):
        if state != "live":
            err = doc["hosts"][host].get("error")
            print(f"  {host}: {state} ({err})", file=sys.stderr)
    for finding in findings:
        print(f"  INVALID: {finding}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from spfft_tpu_torch.obs import fleet

    if args.check:
        doc = json.loads(Path(args.check).read_text())
        findings = fleet.validate_fleet(doc)
        _report(doc if isinstance(doc, dict) else {}, findings)
        return 3 if findings else 0

    hosts = _parse_hosts(args.host)
    if not hosts:
        print("no hosts given (--host NAME=ADDR:PORT)", file=sys.stderr)
        return 1

    from spfft_tpu_torch.serve.rpc import RpcClient

    class _Handle:
        lost = False

        def __init__(self, name, address):
            self.name = name
            self.client = RpcClient(address, timeout_s=args.timeout_s)

    handles = [_Handle(name, address) for name, address in hosts]
    try:
        doc = fleet.fleet_snapshot(handles, timeout_s=args.timeout_s)
    finally:
        for h in handles:
            h.client.close()
    findings = fleet.validate_fleet(doc)
    _report(doc, findings)
    if not any(
        entry.get("state") == "live" for entry in doc["hosts"].values()
    ):
        print("no host answered the scrape", file=sys.stderr)
        return 1
    if args.prom:
        out = fleet.fleet_prometheus_text(doc)
    else:
        out = json.dumps(doc, indent=1, sort_keys=True)
    if args.output:
        Path(args.output).write_text(out)
        print(f"wrote {args.output}", file=sys.stderr)
    else:
        print(out)
    return 3 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
