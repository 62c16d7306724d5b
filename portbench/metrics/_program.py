"""The program's own spans and counters (``clfacedetection_torch.trace``),
read in the process that ran the cell.  Spans add up only while a
profiler records, so they are the traced slice's; counters are the whole
process's.  A checkout of the program without that module gives None."""


def _trace():
    try:
        from clfacedetection_torch import trace
    except ImportError:
        return None
    return trace


def spans():
    """Each span's ``count``, ``seconds``, ``self_seconds`` and
    ``within`` (seconds by enclosing span name), or None."""
    t = _trace()
    return (t.spans() or None) if t is not None else None


def counters():
    """A snapshot of the program's counters, or None."""
    t = _trace()
    return (t.counters() or None) if t is not None else None


def within(s, name: str, outer: str) -> float:
    """The seconds of span ``name`` inside spans named ``outer``."""
    return s[name].get("within", {}).get(outer, 0.0) if name in s else 0.0
