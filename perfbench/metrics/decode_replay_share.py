"""decode_replay_share: the share of the traced window's decode steps that
replayed a captured CUDA graph, in %: the count of the program's
``decode.replay`` spans over that of its ``step.decode`` spans
(``repro_torch.tracing``).  None from a program whose decode step records
none of ``decode.eager``, ``decode.capture`` and ``decode.replay``."""

KINDS = ("decode.eager", "decode.capture", "decode.replay")


def read(r):
    try:
        from repro_torch import tracing
    except ImportError:              # a program that records no spans
        return None
    rows = tracing.summary(tracing.spans())
    steps = rows.get("step.decode")
    if not steps or not any(k in rows for k in KINDS):
        return None
    replays = rows.get("decode.replay", {"count": 0})["count"]
    return 100.0 * replays / steps["count"]
