"""decode_issue_ms_per_step: the host time of a decode step, from the
program's ``step.decode`` spans in the traced window (``repro_torch.
tracing``): from the step's entry to its return, the in-step argmax
issued, before the harness's read of the token waits for the card.  Their
mean; a host-paced decode spends nearly all of a step's wall here."""


def read(r):
    try:
        from repro_torch import tracing
    except ImportError:              # a program that records no spans
        return None
    span = tracing.summary(tracing.spans()).get("step.decode")
    if not span:
        return None
    return span["host_ms"] / span["count"]
