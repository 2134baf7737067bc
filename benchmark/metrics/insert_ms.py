"""Self time of a keyframe insert (``mapping.insert_keyframe``; in the
fleet ``insert_keyframe_streams``, one slot of every stream), a call."""


def read(ctx):
    n = ctx["calls"].get("insert", 0)
    if not n:
        return None
    return ctx["self_s"]["insert"] / n * 1e3
