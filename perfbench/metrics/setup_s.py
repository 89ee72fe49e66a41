"""setup_s: seconds from the process's start to the schedule's start:
imports, the kernels' build on a first run, weights, the engine, the
lowering lookups and the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
