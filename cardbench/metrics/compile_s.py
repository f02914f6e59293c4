"""Seconds of set-up inside the program's ``compile`` spans (layers 1-6 and
the plans' binding), counting nested spans once."""


def read(ctx):
    spans = sorted((s for s in ctx.setup_spans if s["name"].startswith("compile")),
                   key=lambda s: s["ts"])
    total, end = 0.0, None
    for s in spans:
        a, b = s["ts"], s["ts"] + s["dur"]
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6 if spans else None
