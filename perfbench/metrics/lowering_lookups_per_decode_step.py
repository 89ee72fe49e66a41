"""lowering_lookups_per_decode_step: mean compile-cache lookups (the
``lookups`` attribute of the program's ``serve.step`` span, the
dispatcher's hits + misses over the step) of the untraced steps that
decoded and admitted nothing."""

from yardstick.spans import pure_decode_steps, program_spans


def read(run):
    spans = program_spans(run.t_open)
    if spans is None:
        return None
    n = [s.attrs["lookups"] for s, _ in pure_decode_steps(run, spans)]
    return sum(n) / len(n) if n else None
