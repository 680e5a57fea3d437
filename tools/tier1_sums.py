"""Seconds by test file and by xdist worker of one tier-1 run, from its
junit XML and, for the workers, its log.

    python3 tools/tier1_sums.py RUN.xml [RUN.log]

Run the tier-1 command with ``--junitxml=RUN.xml``; with ``-v`` in place
of ``-q`` its log names the worker of every test (``[gw3] PASSED
tests/test_x.py::...``). A file's seconds are the sum of its test cases'
``time`` (setup, call and teardown, so a module fixture counts in its
first test). Under ``--dist loadfile`` each file runs whole on one worker,
so a worker's sum is what it spent on tests, and the busiest worker's sum
sets the run's length.
"""
import collections
import re
import sys
import xml.etree.ElementTree as ET

WORKER = re.compile(r"\[(gw\d+)\] .*?(?:PASSED|FAILED|SKIPPED|ERROR|XFAIL|"
                    r"XPASS) (tests/[^:\s]+\.py)")


def file_sums(xml):
    """{test file: (seconds, test cases)} of a junit XML."""
    sums = collections.defaultdict(lambda: [0.0, 0])
    for case in ET.parse(xml).iter("testcase"):
        parts = case.get("classname", "").split(".")
        name = "/".join(parts[:2]) + ".py"
        sums[name][0] += float(case.get("time", 0))
        sums[name][1] += 1
    return {k: tuple(v) for k, v in sums.items()}


def workers(log):
    """{test file: worker} from a verbose xdist log."""
    out = {}
    with open(log, errors="replace") as f:
        for line in f:
            m = WORKER.match(line)
            if m:
                out.setdefault(m.group(2), m.group(1))
    return out


def main(argv):
    sums = file_sums(argv[0])
    where = workers(argv[1]) if len(argv) > 1 else {}
    if len(argv) > 1 and not where:
        print(f"{argv[1]} names no worker ([gwN] lines come with -v)\n")
    if where:
        by_worker = collections.defaultdict(list)
        for name, (s, _) in sums.items():
            by_worker[where.get(name, "?")].append(s)
        for w in sorted(by_worker):
            print(f"{w}: {sum(by_worker[w]):.1f} s over "
                  f"{len(by_worker[w])} files")
        print()
    for name, (s, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        print(f"{s:8.1f} s {n:5d} tests  {where.get(name, ''):5s} {name}")


if __name__ == "__main__":
    main(sys.argv[1:])
