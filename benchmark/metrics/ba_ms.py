"""Self time of a BA round (``ba.run_ba``, reached through ``run_ba_fb``;
``ba.run_ba_streams`` in the fleet), a round."""


def read(ctx):
    n = ctx["calls"].get("ba", 0)
    if not n:
        return None
    return ctx["self_s"]["ba"] / n * 1e3
