"""Host: the median milliseconds of the fixed host probe
(``benchmark/host.py``), run 5 times just before the window opens and 5
times once it has closed: how fast this run's CPU was, apart from the
program."""


def read(run):
    from benchmark.host import median
    return median(run.host_probe_ms)
