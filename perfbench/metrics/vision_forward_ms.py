"""vision_forward_ms: the device time of the vision tower's forward a train
step, from the program's ``model.vision`` spans in the traced window
(``repro_torch.tracing``): their timing events' intervals, summed over
the window and divided by its ``step.train`` spans.  The span wraps the
tower's forward once a step (the patch embedding and every block); remat's
recomputation of the blocks runs in the backward, outside it."""


def read(r):
    try:
        from repro_torch import tracing
    except ImportError:              # a program that records no spans
        return None
    rows = tracing.summary(tracing.spans())
    span, steps = rows.get("model.vision"), rows.get("step.train")
    if not span or not steps or span["device_ms"] is None:
        return None
    return span["device_ms"] / steps["count"]
