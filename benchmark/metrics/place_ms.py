"""Self time of the place chain (BoW ``Database.add`` / ``query``,
``verify_loop``, ``apply_loop`` / ``apply_loop_pgo``), a frame.  It lands on
keyframes and loop candidates, so it sets the tail more than the mean."""


def read(ctx):
    if not ctx["span_frames"] or "place" not in ctx["self_s"]:
        return None
    return ctx["self_s"]["place"] / ctx["span_frames"] * 1e3
