"""A pytest plugin that counts the CPU seconds of each test file: user +
system time of the test process and of the child processes it waited for,
read at each file boundary (the file's tests, set-up and tear-down of its
fixtures included; collection, which imports every file, is not counted).

    python -m pytest -p tests.torch_cpu_seconds tests/test_torch_a.py ... \
        -q -p no:cacheprovider

prints one line a file at the end, "cpu_seconds <file> <seconds>", and
with CPU_SECONDS_OUT=<path> appends them to that file as JSON lines. Run it
without xdist (one process) so that each file's seconds are its own, and
with torch on one thread (``tests/test_torch_layers.py`` sets it).
"""
import json
import os
import resource

_seconds = {}
_current = [None, 0.0]


def _cpu():
    total = 0.0
    for who in (resource.RUSAGE_SELF, resource.RUSAGE_CHILDREN):
        r = resource.getrusage(who)
        total += r.ru_utime + r.ru_stime
    return total


def _close(now):
    name, start = _current
    if name is not None:
        _seconds[name] = _seconds.get(name, 0.0) + now - start


def pytest_runtest_protocol(item, nextitem):
    path = item.nodeid.split("::")[0]
    if path != _current[0]:
        now = _cpu()
        _close(now)
        _current[:] = [path, now]


def _finish():
    _close(_cpu())
    _current[0] = None


def pytest_sessionfinish(session, exitstatus):
    _finish()
    out = os.environ.get("CPU_SECONDS_OUT")
    lines = [dict(file=k, cpu_s=round(v, 2)) for k, v in _seconds.items()]
    if out:
        with open(out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


def pytest_terminal_summary(terminalreporter):
    _finish()
    for k, v in _seconds.items():
        terminalreporter.write_line(f"cpu_seconds {k} {v:.2f}")
