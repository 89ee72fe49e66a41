"""slot_occupancy: mean share of the engine's slots in use over the decode
steps of the window's untraced part, in %."""


def read(run):
    occ = [s.decode[1] for s in run.steps
           if s.decode is not None and run.untraced(s.t0, s.t1)]
    if not occ:
        return None
    return 100.0 * sum(occ) / (len(occ) * run.cell["engine"]["max_batch"])
