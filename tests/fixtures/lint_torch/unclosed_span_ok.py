"""Negative fixture: every span's end is syntactically guaranteed (or
ownership moved to something that ends it)."""


def with_form(telem, items):
    with telem.begin_span("round_chunk", chunk_seq=0):
        for item in items:
            item.process()


def bound_then_entered(telem, work):
    sp = telem.begin_span("serve") if telem else None
    with sp:
        work()


def try_finally(telem, work):
    sp = telem.begin_span("checkpoint_save")
    try:
        work()
    finally:
        sp.end()


def handoff_to_container(telem, pending):
    # the executor's shape: the span rides a tuple whose consumer ends it
    pending.append((telem.begin_span("round_chunk"), object()))


def handoff_to_attribute(telem, req):
    req.span = telem.begin_span("fleet_request")


def factory(tracer):
    # returning transfers ownership to the caller
    return tracer.begin_span("fit")
