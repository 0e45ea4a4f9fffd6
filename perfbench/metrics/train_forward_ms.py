"""train_forward_ms: the device time of a train step's forward (the loss
included), from the program's ``step.forward`` spans in the traced window
(``repro_torch.tracing``): their timing events' intervals, summed over
the window and divided by its ``step.train`` spans.  Such an interval is
the stream's time between the span's two ends, which is device time
while the card does not idle inside it, as a training window's card
barely does."""


def read(r):
    try:
        from repro_torch import tracing
    except ImportError:              # a program that records no spans
        return None
    rows = tracing.summary(tracing.spans())
    span, steps = rows.get("step.forward"), rows.get("step.train")
    if not span or not steps or span["device_ms"] is None:
        return None
    return span["device_ms"] / steps["count"]
