#!/usr/bin/env python3
"""The cost of the tests in a pytest junit XML, by file and by case.

    python -m pytest tests/ ... --junitxml=run.xml
    python3 orbslam2_tpu_torch/tools/test_budget.py run.xml [--top N]

Prints one JSON line: the summed case seconds of the whole run and of the
port's parity tests (the files ``tests/test_torch_*.py``), their share, and
the ``--top`` slowest files and cases (default 15). A case's
seconds in junit include its fixtures, so the first case of a file carries
the file's module fixtures. With ``-n 6 --dist loadfile`` each file runs on
one worker, and the summed seconds are the CPU time the run spends, not its
wall time (the last lines of pytest's own output give that).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import xml.etree.ElementTree as ET


PORT_PREFIX = "test_torch_"


def node_file(case: ET.Element) -> tuple[str, str]:
    """-> (test file, node id) of a junit <testcase>, from the module path in
    its ``classname`` ("tests.test_x.TestY" -> "tests/test_x.py")."""
    parts = case.get("classname", "").split(".")
    depth = next((i for i, p in enumerate(parts) if p.startswith("test_")), len(parts) - 1)
    path = "/".join(parts[:depth + 1]) + ".py"
    return path, "::".join([path, *parts[depth + 1:], case.get("name", "")])


def budget(xml_path: str, top: int = 15) -> dict:
    """The report as a dict (see the module's docstring)."""
    files = collections.defaultdict(lambda: [0.0, 0])
    cases = []
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        path, node = node_file(case)
        secs = float(case.get("time", 0.0))
        files[path][0] += secs
        files[path][1] += 1
        cases.append((secs, node))
    total = sum(s for s, _ in files.values())
    port = {f: v for f, v in files.items() if f.rsplit("/", 1)[-1].startswith(PORT_PREFIX)}
    port_s = sum(s for s, _ in port.values())
    by_time = sorted(files.items(), key=lambda kv: -kv[1][0])
    return dict(
        total_s=round(total, 3), cases=len(cases), files=len(files),
        port_s=round(port_s, 3), port_cases=sum(c for _, c in port.values()),
        port_files=len(port), port_share=round(port_s / total, 4) if total else 0.0,
        slowest_files=[dict(file=f, s=round(s, 3), cases=c, port=f in port)
                       for f, (s, c) in by_time[:top]],
        slowest_cases=[dict(id=node, s=round(s, 3))
                       for s, node in sorted(cases, key=lambda c: -c[0])[:top]])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml", help="pytest --junitxml output")
    ap.add_argument("--top", type=int, default=15, help="slowest files and cases listed")
    args = ap.parse_args(argv)
    json.dump(budget(args.xml, args.top), sys.stdout)
    print()


if __name__ == "__main__":
    main()
