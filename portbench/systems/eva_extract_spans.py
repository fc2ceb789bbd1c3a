"""The spans of eva_extract's program for program_spans.py: what
hirest_tpu_torch.utils.profiling recorded in this process, or nothing
where the port records no spans."""

from portbench.program_spans import Span


def program_spans() -> list:
    from hirest_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return []
    return [Span(r.start_ns, r.end_ns, r.name, r.thread, r.attrs)
            for r in spans()]
