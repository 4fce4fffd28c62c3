"""Positive fixture: spans started without a guaranteed end."""


def dropped(telem):
    # bare statement: the returned span is discarded — nothing ends it
    telem.begin_span("round_chunk", chunk_seq=0)


def bound_but_leaky(telem, items):
    sp = telem.begin_span("shard_load")
    for item in items:
        item.process()
    sp.end()  # a plain call can be skipped by any raise above it
    return items


def conditional_end(tracer, ok):
    span = tracer.start_span("serve")
    if ok:
        span.end()
    return ok
