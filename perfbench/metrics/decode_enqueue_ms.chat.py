"""decode_enqueue_ms.chat: median ms the host takes to enqueue a decode
step (the program's ``serve.decode.enqueue`` span, before the token fetch
waits for the device), over the untraced ``serve.step``s that decoded and
admitted nothing; beside ``decode_step_ms.chat`` it says host or device."""

import statistics

from yardstick.spans import pure_decode_steps, program_spans


def read(run):
    spans = program_spans(run.t_open)
    if spans is None:
        return None
    ms = [1e3 * (c.t1 - c.t0) for _, kids in pure_decode_steps(run, spans)
          for c in kids if c.name == "serve.decode.enqueue"]
    return statistics.median(ms) if ms else None
